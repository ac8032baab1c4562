"""The altair `process_epoch` over the struct-of-arrays registry
(counterpart of engine/epoch.py).

`make_epoch_fn(cfg)` returns `process_epoch(state) -> (state, aux)`, which
updates `state` IN PLACE and returns it (the JAX program donates its input
instead). On CUDA tensors it runs kernel K3 (csrc/epoch.cu) as a fixed
sequence of launches with no host sync; on CPU tensors it runs
`process_epoch_plain`, the same program in plain PyTorch, and copies the
result into `state`. `make_epoch_fn(cfg, mesh)` runs the step over a
registry sharded on a mesh (`sharded_epoch_step`): K3's phases, or their
plain versions, with gathers where the ranks must agree.

    spec function                       here (kernel phase / plain version)
    ----------------------------------  -----------------------------------
    process_justification_and_final...  K3 scalars step / epoch_sweep_a_plain
    process_inactivity_updates          K3 sweep A / epoch_sweep_a_plain
    process_rewards_and_penalties       K3 sweep A / epoch_sweep_a_plain
    process_registry_updates            K3 sweep A+B with cumsum and sort
                                        glue / the same with the plain mark
    process_slashings                   K3 sweep B / epoch_sweep_b_plain
    process_effective_balance_updates   K3 sweep B / epoch_sweep_b_plain
    slashings / randao resets, flag     K3 finalize / epoch_finalize_plain
    rotation, EpochAux
    process_historical_roots_update     historical_append_root (K19), with
                                        historical_batch_root (K1) its oracle

Hazards both versions handle (and the tests cover):
- FAR_FUTURE_EPOCH = 2**64 - 1 reads as -1 in int64: every <, <=, max and
  sort over epochs in the plain version goes through utils/u64.py
  (`is_active`'s epoch < exit_epoch, prev + 1 < withdrawable_epoch,
  has_exit, the activation sort key).
- The JAX lexsort over (sort_key, index) equals a stable sort on the
  unsigned key only if FAR sorts last: the key is sign-flipped.
- dirty_cols compares final against pre values. Sweep A writes its
  balances into a scratch column and leaves `balances` at the pre value
  until sweep B, which holds both in registers for the compare.
- u64 products wrap at 2**64 in JAX and in K3. The plain version computes
  in int64 and equals them while base_reward * weight * up_increments,
  effective_balance * inactivity_score and
  effective_balance // EBI * adjusted_slashings stay below 2**63 (true for
  registries up to tens of millions of validators with scores below 2**28).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache, reduce

import torch

from ..kernels import build
from ..ops.sha256 import sha256_64B_words
from ..utils.device import is_cpu
from ..utils.u64 import FAR, as_i64, as_u64, sort_key, ule, ult, umax_reduce
from .state import DIRTY_TRACKED, EpochAux, EpochConfig, EpochState
from .state_root import _vector_root_words, tree_root_batch

U64 = 2**64 - 1


def _isqrt_u64(x: int) -> int:
    """The JAX program's float64 sqrt with its +-1 corrections, in u64 wrap
    arithmetic (exact for x < 2**57, the total-active-balance domain)."""
    s = int(math.sqrt(float(x)))
    if (s * s) & U64 > x:
        s -= 1
    if (s * s) & U64 > x:
        s -= 1
    if ((s + 1) * (s + 1)) & U64 <= x:
        s += 1
    return s


def historical_batch_root(block_roots: torch.Tensor, state_roots: torch.Tensor) -> torch.Tensor:
    """hash_tree_root(HistoricalBatch(block_roots, state_roots)) as (8,)
    int32 words, through K1 launches on CUDA (engine/epoch.py:72)."""
    top = torch.cat([_vector_root_words(block_roots, sha256_64B_words),
                     _vector_root_words(state_roots, sha256_64B_words)])
    return sha256_64B_words(top[None])[0]


def historical_append_root(block_roots: torch.Tensor, state_roots: torch.Tensor) -> torch.Tensor:
    """The same root as `historical_batch_root`, as the historical append
    computes it: with SLOTS_PER_HISTORICAL_ROOT a power of two,
    hash(root(block_roots), root(state_roots)) is the root of one tree over
    the two vectors' concatenated rows, which kernel K19 folds in two
    launches on CUDA (engine/bridge.py:49 of the JAX package sends the same
    tree through its Merkle lane's `tree_root_batch`)."""
    return tree_root_batch(torch.cat([block_roots, state_roots])[None])[0]


# ---------------------------------------------------------------------------
# Plain version, phase by phase
#
# The phases of K3 (csrc/epoch.cu) in plain PyTorch, on the same buffers:
# `scal` is the kernel's (32,) int64 vector of uint64 scalars (slots S_*
# below, its enum), the columns are updated in place where the kernel's are.
# `process_epoch_plain` composes them on a copy of the state; the sharded
# step (`sharded_epoch_step`) runs them on a rank's block with collectives
# between them.

S_TAB_SUM, S_CURR_TARGET, S_FLAG0 = 0, 1, 2
S_ACTIVE_COUNT, S_MAX_EXIT, S_SLASHINGS_SUM, S_FRONTIER_COUNT, S_DIRTY = 5, 6, 7, 8, 9
S_CUR, S_PREV, S_NXT, S_FIN, S_LEAK, S_RUN, S_TAB, S_ACTIVE_INC, S_BRPI = range(10, 19)
S_UP0 = 19
S_CHURN, S_ACT_EXIT, S_FRONTIER, S_ADJUSTED = 22, 23, 24, 25
_D = {name: k for k, name in enumerate(DIRTY_TRACKED)}  # dirty bit of each column
_N_SCAL = 32  # device scalar slots (u64 scal[32] in csrc/epoch.cu)


def _has_flag(part: torch.Tensor, flag_index: int) -> torch.Tensor:
    bit = 1 << flag_index
    return (part & bit) == bit


def _get(scal: torch.Tensor, k: int) -> int:
    return as_u64(int(scal[k]))


def _put(scal: torch.Tensor, k: int, v: int) -> None:
    scal[k] = as_i64(v)


def _epochs(cfg: EpochConfig, st: EpochState) -> tuple:
    cur = as_u64(int(st.slot)) // cfg.slots_per_epoch
    return cur, (cur - 1 if cur > cfg.genesis_epoch else cfg.genesis_epoch)


def _is_active(act, ext, epoch):
    return ule(act, epoch) & ult(epoch, ext)


def epoch_reduce_plain(cfg: EpochConfig, st: EpochState, scal: torch.Tensor) -> None:
    """Plain version of K3's reduce: scal zeroed, then the sums of this
    block of the registry (and of the whole replicated slashings vector)."""
    scal.zero_()
    cur, prev = _epochs(cfg, st)
    act, ext, eff, slashed = st.activation_epoch, st.exit_epoch, st.effective_balance, st.slashed
    active_cur, active_prev = _is_active(act, ext, cur), _is_active(act, ext, prev)

    def total(mask) -> int:
        return int(torch.where(mask, eff, 0).sum())

    _put(scal, S_TAB_SUM, total(active_cur))
    _put(scal, S_CURR_TARGET, total(active_cur & ~slashed & _has_flag(
        st.curr_participation, cfg.timely_target_flag_index)))
    for f in range(3):
        _put(scal, S_FLAG0 + f, total(active_prev & ~slashed
                                      & _has_flag(st.prev_participation, f)))
    _put(scal, S_ACTIVE_COUNT, int(active_cur.sum()))
    _put(scal, S_MAX_EXIT, int(umax_reduce(torch.where(ext != FAR, ext, 0))))
    _put(scal, S_SLASHINGS_SUM, int(st.slashings.sum()))


def epoch_combine_plain(parts: torch.Tensor, stage: int) -> torch.Tensor:
    """Plain version of `epoch_combine`: the fold of w ranks' scal vectors
    (w, 32) at `stage` (see csrc/epoch.cu combine_kernel)."""
    out = parts[0].clone()
    out[S_DIRTY] = reduce(torch.bitwise_or, parts[:, S_DIRTY].unbind())
    if stage <= 1:
        out[S_FRONTIER_COUNT] = parts[:, S_FRONTIER_COUNT].sum()
    if stage == 0:
        out[:S_ACTIVE_COUNT + 1] = parts[:, :S_ACTIVE_COUNT + 1].sum(0)
        out[S_MAX_EXIT] = umax_reduce(parts[:, S_MAX_EXIT])
    return out


def epoch_sweep_a_plain(cfg: EpochConfig, st: EpochState, scal: torch.Tensor,
                        bal_mid: torch.Tensor, eject: torch.Tensor, key: torch.Tensor) -> None:
    """Plain version of K3's scalars step and sweep A, over the sums in
    scal: justification and finalization (the checkpoints and bits, in
    place), the epoch's scalars into scal, then inactivity (in place),
    rewards and penalties into bal_mid, the eject flags, the activation
    sort keys (sign-flipped), this block's frontier count and dirty bits."""
    EBI = cfg.effective_balance_increment
    WD = cfg.weight_denominator
    i64 = as_i64
    cur, prev = _epochs(cfg, st)
    tab = max(_get(scal, S_TAB_SUM), EBI)
    fin = as_u64(int(st.finalized_epoch))

    # -- process_justification_and_finalization ----------------------------
    if cur > cfg.genesis_epoch + 1:
        prev_target = max(_get(scal, S_FLAG0 + cfg.timely_target_flag_index), EBI)
        curr_target = max(_get(scal, S_CURR_TARGET), EBI)
        old_pj = as_u64(int(st.prev_justified_epoch))
        old_cj = as_u64(int(st.curr_justified_epoch))
        old_pr, old_cr = st.prev_justified_root.clone(), st.curr_justified_root.clone()
        bits = [False] + [bool(b) for b in st.justification_bits[:3].tolist()]
        new_j, new_jr = old_cj, old_cr

        def block_root_at(epoch):
            return st.block_roots[(epoch * cfg.slots_per_epoch & U64) % cfg.slots_per_historical_root]

        if (prev_target * 3) & U64 >= (tab * 2) & U64:
            new_j, new_jr = prev, block_root_at(prev)
            bits[1] = True
        if (curr_target * 3) & U64 >= (tab * 2) & U64:
            new_j, new_jr = cur, block_root_at(cur)
            bits[0] = True
        fin_r = st.finalized_root.clone()
        rules = [
            (bits[1] and bits[2] and bits[3], (old_pj + 3) & U64 == cur, old_pj, old_pr),
            (bits[1] and bits[2], (old_pj + 2) & U64 == cur, old_pj, old_pr),
            (bits[0] and bits[1] and bits[2], (old_cj + 2) & U64 == cur, old_cj, old_cr),
            (bits[0] and bits[1], (old_cj + 1) & U64 == cur, old_cj, old_cr),
        ]
        for bits_ok, dist_ok, e, r in rules:
            if bits_ok and dist_ok:
                fin, fin_r = e, r
        st.prev_justified_epoch.fill_(i64(old_cj))
        st.prev_justified_root.copy_(old_cr)
        st.curr_justified_epoch.fill_(i64(new_j))
        st.curr_justified_root.copy_(new_jr)
        st.justification_bits.copy_(torch.tensor(bits, device=st.device))
        st.finalized_epoch.fill_(i64(fin))
        st.finalized_root.copy_(fin_r)

    # -- the epoch's scalars -----------------------------------------------
    leak = ((prev - fin) & U64) > cfg.min_epochs_to_inactivity_penalty
    run = cur > cfg.genesis_epoch
    active_increments = tab // EBI
    brpi = (EBI * cfg.base_reward_factor) // _isqrt_u64(tab)
    up = [max(_get(scal, S_FLAG0 + f), EBI) // EBI for f in range(3)]
    act_exit = cur + 1 + cfg.max_seed_lookahead
    frontier = max(_get(scal, S_MAX_EXIT), act_exit)
    for k, v in ((S_CUR, cur), (S_PREV, prev), (S_NXT, cur + 1), (S_FIN, fin),
                 (S_LEAK, int(leak)), (S_RUN, int(run)), (S_TAB, tab),
                 (S_ACTIVE_INC, active_increments), (S_BRPI, brpi),
                 (S_UP0, up[0]), (S_UP0 + 1, up[1]), (S_UP0 + 2, up[2]),
                 (S_CHURN, max(cfg.min_per_epoch_churn_limit,
                               _get(scal, S_ACTIVE_COUNT) // cfg.churn_limit_quotient)),
                 (S_ACT_EXIT, act_exit), (S_FRONTIER, frontier),
                 (S_ADJUSTED, min((_get(scal, S_SLASHINGS_SUM)
                                   * cfg.proportional_slashing_multiplier) & U64, tab))):
        _put(scal, k, v & U64)

    act, ext = st.activation_epoch, st.exit_epoch
    eff, slashed = st.effective_balance, st.slashed
    active_cur, active_prev = _is_active(act, ext, cur), _is_active(act, ext, prev)
    eligible = active_prev | (slashed & ult(prev + 1, st.withdrawable_epoch))
    target_part = (active_prev & ~slashed
                   & _has_flag(st.prev_participation, cfg.timely_target_flag_index))
    dirty = 0

    # -- process_inactivity_updates ----------------------------------------
    score = st.inactivity_scores
    if run:
        new = torch.where(eligible & target_part, score - torch.clamp(score, max=1), score)
        new = torch.where(eligible & ~target_part, new + cfg.inactivity_score_bias, new)
        if not leak:
            recovery = torch.clamp(new, max=cfg.inactivity_score_recovery_rate)
            new = torch.where(eligible, new - recovery, new)
        if bool((new != score).any()):
            dirty |= 1 << _D["inactivity_scores"]
        score.copy_(new)

    # -- process_rewards_and_penalties -------------------------------------
    bal = st.balances
    if run:
        base_reward = (eff // EBI) * brpi
        deltas = []
        for flag_index, weight in enumerate(cfg.participation_flag_weights):
            participating = active_prev & ~slashed & _has_flag(st.prev_participation, flag_index)
            if leak:
                reward = torch.zeros_like(base_reward)
            else:
                reward = torch.where(
                    eligible & participating,
                    base_reward * weight * up[flag_index] // i64((active_increments * WD) & U64),
                    0)
            if flag_index != cfg.timely_head_flag_index:
                penalty = torch.where(eligible & ~participating, base_reward * weight // WD, 0)
            else:
                penalty = torch.zeros_like(base_reward)
            deltas.append((reward, penalty))
        inactivity_penalty = torch.where(
            eligible & ~target_part,
            eff * score // (cfg.inactivity_score_bias * cfg.inactivity_penalty_quotient),
            0)
        deltas.append((torch.zeros_like(base_reward), inactivity_penalty))
        for reward, penalty in deltas:  # sequential clamp at zero, spec order
            bal = bal + reward
            bal = bal - torch.minimum(penalty, bal)
    bal_mid.copy_(bal)

    # -- the registry updates' inputs --------------------------------------
    eject.copy_(active_cur & ule(eff, cfg.ejection_balance) & (ext == FAR))
    aee = torch.where((st.activation_eligibility_epoch == FAR)
                      & (eff == cfg.max_effective_balance),
                      i64(cur + 1), st.activation_eligibility_epoch)
    elig_act = ule(aee, fin) & (act == FAR)
    key.copy_(sort_key(torch.where(elig_act, aee, FAR)))  # stable sort == lexsort((idx, key))
    scal[S_FRONTIER_COUNT] += int((ext == i64(frontier)).sum())
    scal[S_DIRTY] |= dirty


def epoch_mark_plain(order: torch.Tensor, scal: torch.Tensor, rank_ok: torch.Tensor) -> None:
    """Plain version of K3's mark: rank_ok[order[j]] = j < churn."""
    ranks = torch.arange(order.shape[0], device=order.device)
    rank_ok[order] = (ranks < _get(scal, S_CHURN)).to(rank_ok.dtype)


def epoch_sweep_b_plain(cfg: EpochConfig, st: EpochState, scal: torch.Tensor,
                        bal_mid: torch.Tensor, eject: torch.Tensor, cums: torch.Tensor,
                        rank_ok: torch.Tensor) -> None:
    """Plain version of K3's sweep B, in place: exits from the queue
    positions cums - 1, activations where rank_ok, slashings, effective
    balances, the participation rotation; this block's dirty bits."""
    EBI = cfg.effective_balance_increment
    i64 = as_i64
    cur, fin, churn = _get(scal, S_CUR), _get(scal, S_FIN), _get(scal, S_CHURN)
    act_exit, frontier = _get(scal, S_ACT_EXIT), _get(scal, S_FRONTIER)
    fc = _get(scal, S_FRONTIER_COUNT)
    tab, adjusted = _get(scal, S_TAB), _get(scal, S_ADJUSTED)
    avail0 = churn - fc if churn > fc else 0
    eff, act = st.effective_balance, st.activation_epoch

    # -- process_registry_updates ------------------------------------------
    ejected = eject.bool()
    qpos = cums - 1  # queue position of each ejected validator
    assigned = torch.where(ult(qpos, avail0), i64(frontier),
                           i64(frontier + 1) + (qpos - avail0) // churn)
    new_exit = torch.where(ejected, assigned, st.exit_epoch)
    new_wd = torch.where(ejected, assigned + cfg.min_validator_withdrawability_delay,
                         st.withdrawable_epoch)
    aee = torch.where((st.activation_eligibility_epoch == FAR)
                      & (eff == cfg.max_effective_balance),
                      i64(cur + 1), st.activation_eligibility_epoch)
    elig_act = ule(aee, fin) & (act == FAR)
    new_act = torch.where(elig_act & rank_ok.bool(), i64(act_exit), act)

    # -- process_slashings -------------------------------------------------
    # over `tab`: the total active balance of the post-registry columns
    # equals it (new activations and exits lie after `cur`)
    hit = st.slashed & (new_wd == i64(cur + cfg.epochs_per_slashings_vector // 2))
    penalty = torch.where(hit, eff // EBI * adjusted // tab * EBI, 0)
    bal = bal_mid - torch.minimum(penalty, bal_mid)

    # -- process_effective_balance_updates ---------------------------------
    hyst = EBI // cfg.hysteresis_quotient
    down = hyst * cfg.hysteresis_downward_multiplier
    up = hyst * cfg.hysteresis_upward_multiplier
    moved = ult(bal + down, eff) | ult(eff + up, bal)
    new_eff = torch.where(moved, torch.clamp(bal - bal % EBI, max=cfg.max_effective_balance), eff)

    # -- participation rotation, dirty bits, in place ----------------------
    curr = st.curr_participation.clone()
    new = {"balances": bal, "effective_balance": new_eff, "activation_eligibility_epoch": aee,
           "activation_epoch": new_act, "exit_epoch": new_exit, "withdrawable_epoch": new_wd,
           "prev_participation": curr, "curr_participation": torch.zeros_like(curr)}
    dirty = 0
    for name, t in new.items():
        col = getattr(st, name)
        if bool((t != col).any()):
            dirty |= 1 << _D[name]
        col.copy_(t)
    scal[S_DIRTY] |= dirty


def epoch_finalize_plain(cfg: EpochConfig, st: EpochState, scal: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's finalize: the slashings and randao resets (in
    place) and the aux vector, (3 + len(DIRTY_TRACKED),) bool."""
    cur, nxt = _get(scal, S_CUR), _get(scal, S_NXT)
    dirty = _get(scal, S_DIRTY)
    row = nxt % cfg.epochs_per_slashings_vector
    if int(st.slashings[row]) != 0:
        st.slashings[row] = 0
        dirty |= 1 << _D["slashings"]
    ephv = cfg.epochs_per_historical_vector
    src = st.randao_mixes[cur % ephv].clone()
    if not torch.equal(st.randao_mixes[nxt % ephv], src):
        st.randao_mixes[nxt % ephv] = src
        dirty |= 1 << _D["randao_mixes"]
    epochs_per_batch = cfg.slots_per_historical_root // cfg.slots_per_epoch
    flags = [nxt % epochs_per_batch == 0, nxt % cfg.epochs_per_eth1_voting_period == 0,
             nxt % cfg.epochs_per_sync_committee_period == 0]
    return torch.tensor(flags + [bool((dirty >> k) & 1) for k in range(len(DIRTY_TRACKED))],
                        device=st.device)


def process_epoch_plain(cfg: EpochConfig, st: EpochState):
    """The JAX `process_epoch` in plain PyTorch: returns a NEW
    (EpochState, EpochAux) and leaves `st` untouched. The composition of
    the plain phases above with the single-device glue (a cumsum over the
    eject flags, a stable sort over the activation keys). Scalars are
    Python ints in u64 wrap arithmetic; columns are int64 (domain above)."""
    out = st.clone()
    n, dev = out.num_validators, out.device
    scal = torch.zeros(_N_SCAL, dtype=torch.int64, device=dev)
    bal_mid = torch.empty(n, dtype=torch.int64, device=dev)
    eject = torch.empty(n, dtype=torch.uint8, device=dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    rank_ok = torch.zeros(n, dtype=torch.uint8, device=dev)
    epoch_reduce_plain(cfg, out, scal)
    epoch_sweep_a_plain(cfg, out, scal, bal_mid, eject, key)
    cums = torch.cumsum(eject, 0)
    order = torch.sort(key, stable=True).indices
    epoch_mark_plain(order, scal, rank_ok)
    epoch_sweep_b_plain(cfg, out, scal, bal_mid, eject, cums, rank_ok)
    return out, EpochAux.from_flat(epoch_finalize_plain(cfg, out, scal))


# ---------------------------------------------------------------------------
# Kernel K3


def _params(cfg: EpochConfig) -> list:
    """The fields of csrc/epoch.cu's EpochParams struct, in its order."""
    if len(cfg.participation_flag_weights) != 3:
        raise ValueError("the epoch kernel handles exactly three participation flags")
    hyst = cfg.effective_balance_increment // cfg.hysteresis_quotient
    vals = [
        cfg.slots_per_epoch, cfg.epochs_per_slashings_vector,
        cfg.epochs_per_historical_vector, cfg.slots_per_historical_root,
        cfg.max_effective_balance, cfg.effective_balance_increment,
        cfg.base_reward_factor, hyst * cfg.hysteresis_downward_multiplier,
        hyst * cfg.hysteresis_upward_multiplier, cfg.min_epochs_to_inactivity_penalty,
        cfg.proportional_slashing_multiplier,
        cfg.inactivity_score_bias * cfg.inactivity_penalty_quotient,
        cfg.max_seed_lookahead, cfg.epochs_per_sync_committee_period,
        cfg.weight_denominator, *cfg.participation_flag_weights,
        cfg.timely_head_flag_index, cfg.timely_target_flag_index,
        cfg.inactivity_score_bias, cfg.inactivity_score_recovery_rate,
        cfg.min_per_epoch_churn_limit, cfg.churn_limit_quotient, cfg.ejection_balance,
        cfg.min_validator_withdrawability_delay, cfg.epochs_per_eth1_voting_period,
        cfg.genesis_epoch, cfg.far_future_epoch,
    ]
    return [v & U64 for v in vals]


@lru_cache(maxsize=None)
def _kernel_params(cfg: EpochConfig) -> ctypes.Array:
    """`_params(cfg)` as the C EpochParams struct, checked once against the
    built library's struct size."""
    vals = _params(cfg)
    if build.library("epoch").epoch_params_count() != len(vals):
        raise RuntimeError("EpochParams in csrc/epoch.cu is out of step with _params()")
    return (ctypes.c_uint64 * len(vals))(*vals)


_COLUMNS = (("balances", torch.int64), ("effective_balance", torch.int64),
            ("activation_eligibility_epoch", torch.int64), ("activation_epoch", torch.int64),
            ("exit_epoch", torch.int64), ("withdrawable_epoch", torch.int64),
            ("slashed", torch.bool), ("prev_participation", torch.uint8),
            ("curr_participation", torch.uint8), ("inactivity_scores", torch.int64))


def _check_state(cfg: EpochConfig, st: EpochState) -> None:
    n = st.num_validators
    for name, dtype in _COLUMNS:
        t = getattr(st, name)
        if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous() or t.device != st.device:
            raise ValueError(f"epoch_sweep: column {name} must be contiguous ({n},) {dtype} "
                             f"on {st.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    shapes = {
        "slot": ((), torch.int64),
        "slashings": ((cfg.epochs_per_slashings_vector,), torch.int64),
        "randao_mixes": ((cfg.epochs_per_historical_vector, 8), torch.int32),
        "block_roots": ((cfg.slots_per_historical_root, 8), torch.int32),
        "justification_bits": ((4,), torch.bool),
        "prev_justified_epoch": ((), torch.int64), "prev_justified_root": ((8,), torch.int32),
        "curr_justified_epoch": ((), torch.int64), "curr_justified_root": ((8,), torch.int32),
        "finalized_epoch": ((), torch.int64), "finalized_root": ((8,), torch.int32),
    }
    for name, (shape, dtype) in shapes.items():
        t = getattr(st, name)
        if (tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous()
                or t.device != st.device):
            raise ValueError(f"epoch_sweep: {name} must be contiguous {shape} {dtype} "
                             f"on {st.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _buffers(n: int, dev) -> tuple:
    """scal, bal_mid, eject, key: the scratch one epoch step fills."""
    return (torch.empty(_N_SCAL, dtype=torch.int64, device=dev),
            torch.empty(n, dtype=torch.int64, device=dev),
            torch.empty(n, dtype=torch.uint8, device=dev),
            torch.empty(n, dtype=torch.int64, device=dev))


def _ckpts(st: EpochState) -> ctypes.Array:
    return (ctypes.c_void_p * 6)(
        st.prev_justified_epoch.data_ptr(), st.prev_justified_root.data_ptr(),
        st.curr_justified_epoch.data_ptr(), st.curr_justified_root.data_ptr(),
        st.finalized_epoch.data_ptr(), st.finalized_root.data_ptr())


def _phase1_args(st: EpochState, ckpts) -> tuple:
    """epoch_sweep_a's state pointers, after `params`: slot, the eight
    columns it reads, inactivity_scores, block_roots, bits, checkpoints."""
    return (st.slot.data_ptr(), st.balances.data_ptr(), st.effective_balance.data_ptr(),
            st.activation_eligibility_epoch.data_ptr(), st.activation_epoch.data_ptr(),
            st.exit_epoch.data_ptr(), st.withdrawable_epoch.data_ptr(), st.slashed.data_ptr(),
            st.prev_participation.data_ptr(), st.inactivity_scores.data_ptr(),
            st.block_roots.data_ptr(), st.justification_bits.data_ptr(),
            ctypes.addressof(ckpts))


def _sweep_b_args(st: EpochState) -> tuple:
    return (st.balances.data_ptr(), st.effective_balance.data_ptr(),
            st.activation_eligibility_epoch.data_ptr(), st.activation_epoch.data_ptr(),
            st.exit_epoch.data_ptr(), st.withdrawable_epoch.data_ptr(), st.slashed.data_ptr(),
            st.prev_participation.data_ptr(), st.curr_participation.data_ptr())


def epoch_sweep(cfg: EpochConfig, st: EpochState) -> EpochAux:
    """Kernel K3: one `process_epoch` over CUDA tensors, in place. Launch
    sequence: reduce -> scalars -> sweep A (`epoch_phase1`), then cumsum
    and stable-sort glue, then mark -> sweep B -> finalize
    (`epoch_phase2`). No host sync.

    Overwrites in place: the ten registry columns, `slashings` (one row),
    `randao_mixes` (one row), `justification_bits` and the three
    checkpoints. `slot` is read, not advanced."""
    _check_state(cfg, st)
    params = _kernel_params(cfg)
    ckpts = _ckpts(st)
    n = st.num_validators
    dev = st.device
    stream = build.stream_ptr(st.balances)
    scal, bal_mid, eject, key = _buffers(n, dev)
    rank_ok = torch.empty(n, dtype=torch.uint8, device=dev)
    aux = torch.empty(3 + len(DIRTY_TRACKED), dtype=torch.bool, device=dev)
    col = {name: getattr(st, name).data_ptr() for name, _ in _COLUMNS}

    build.count_launch("epoch_sweep")
    build.check(build.entry("epoch", "epoch_phase1", 20)(
        ctypes.addressof(params), st.slot.data_ptr(), col["balances"],
        col["effective_balance"], col["activation_eligibility_epoch"],
        col["activation_epoch"], col["exit_epoch"], col["withdrawable_epoch"], col["slashed"],
        col["prev_participation"], col["curr_participation"], col["inactivity_scores"],
        st.slashings.data_ptr(), st.block_roots.data_ptr(), st.justification_bits.data_ptr(),
        ctypes.addressof(ckpts), scal.data_ptr(), bal_mid.data_ptr(), eject.data_ptr(),
        key.data_ptr(), n, stream), "epoch_phase1")

    # glue: queue positions of the ejected validators, and the activation
    # order (a stable sort on the sign-flipped unsigned key == the lexsort)
    cums = torch.cumsum(eject, 0)
    order = torch.sort(key, stable=True).indices

    build.check(build.entry("epoch", "epoch_phase2", 19)(
        ctypes.addressof(params), col["balances"], col["effective_balance"],
        col["activation_eligibility_epoch"], col["activation_epoch"], col["exit_epoch"],
        col["withdrawable_epoch"], col["slashed"], col["prev_participation"],
        col["curr_participation"], st.slashings.data_ptr(), st.randao_mixes.data_ptr(),
        scal.data_ptr(), bal_mid.data_ptr(), eject.data_ptr(), cums.data_ptr(),
        order.data_ptr(), rank_ok.data_ptr(), aux.data_ptr(), n, stream), "epoch_phase2")
    return EpochAux.from_flat(aux)


# --- K3's phases as separate entries (the sharded step runs them) ----------


def epoch_reduce(cfg: EpochConfig, st: EpochState, scal: torch.Tensor) -> None:
    """K3's reduce (`epoch_reduce`): scal zeroed, then this block's sums.
    Kernel on CUDA, plain on the CPU. Counts one K3 launch: a sharded step
    starts with it, as a single-device step starts with `epoch_phase1`."""
    if is_cpu(st.balances):
        return epoch_reduce_plain(cfg, st, scal)
    _check_state(cfg, st)
    build.count_launch("epoch_sweep")
    build.check(build.entry("epoch", "epoch_reduce", 10)(
        ctypes.addressof(_kernel_params(cfg)), st.slot.data_ptr(),
        st.effective_balance.data_ptr(), st.activation_epoch.data_ptr(),
        st.exit_epoch.data_ptr(), st.slashed.data_ptr(), st.prev_participation.data_ptr(),
        st.curr_participation.data_ptr(), st.slashings.data_ptr(), scal.data_ptr(),
        st.num_validators, build.stream_ptr(scal)), "epoch_reduce")


def epoch_sweep_a(cfg: EpochConfig, st: EpochState, scal, bal_mid, eject, key) -> None:
    """K3's scalars step and sweep A (`epoch_sweep_a`) over the sums in
    scal. Kernel on CUDA, plain on the CPU."""
    if is_cpu(st.balances):
        return epoch_sweep_a_plain(cfg, st, scal, bal_mid, eject, key)
    ckpts = _ckpts(st)
    build.check(build.entry("epoch", "epoch_sweep_a", 18)(
        ctypes.addressof(_kernel_params(cfg)), *_phase1_args(st, ckpts), scal.data_ptr(),
        bal_mid.data_ptr(), eject.data_ptr(), key.data_ptr(), st.num_validators,
        build.stream_ptr(scal)), "epoch_sweep_a")


def epoch_combine(parts: torch.Tensor, stage: int) -> torch.Tensor:
    """`epoch_combine`: the fold of w ranks' scal vectors, (w, 32) int64 ->
    (32,), at stage 0 (after reduce), 1 (after sweep A) or 2 (after sweep
    B); see csrc/epoch.cu combine_kernel. Kernel on CUDA, plain on the CPU."""
    if parts.dtype != torch.int64 or parts.dim() != 2 or parts.shape[1] != _N_SCAL \
            or parts.shape[0] < 1 or stage not in (0, 1, 2):
        raise ValueError(f"epoch_combine takes (w >= 1, {_N_SCAL}) int64 and a stage in "
                         f"0..2, got {tuple(parts.shape)} {parts.dtype}, stage {stage}")
    if is_cpu(parts):
        return epoch_combine_plain(parts, stage)
    parts = parts.contiguous()
    out = torch.empty(_N_SCAL, dtype=torch.int64, device=parts.device)
    build.count_launch("epoch_combine")
    build.check(build.entry("epoch", "epoch_combine", 2, 1)(
        parts.data_ptr(), out.data_ptr(), parts.shape[0], stage, build.stream_ptr(parts)),
        "epoch_combine")
    return out


def epoch_mark(order: torch.Tensor, scal: torch.Tensor, rank_ok: torch.Tensor) -> None:
    """K3's mark (`epoch_mark`) over an order of any length: rank_ok[order[j]]
    = j < churn. Kernel on CUDA, plain on the CPU."""
    if is_cpu(order):
        return epoch_mark_plain(order, scal, rank_ok)
    build.check(build.entry("epoch", "epoch_mark", 3)(
        order.data_ptr(), scal.data_ptr(), rank_ok.data_ptr(), order.shape[0],
        build.stream_ptr(order)), "epoch_mark")


def epoch_sweep_b(cfg: EpochConfig, st: EpochState, scal, bal_mid, eject, cums,
                  rank_ok) -> None:
    """K3's sweep B (`epoch_sweep_b`), in place. Kernel on CUDA, plain on
    the CPU."""
    if is_cpu(st.balances):
        return epoch_sweep_b_plain(cfg, st, scal, bal_mid, eject, cums, rank_ok)
    for t in (cums, rank_ok):
        if t.shape != (st.num_validators,) or not t.is_contiguous():
            raise ValueError("epoch_sweep_b: cums and rank_ok must be contiguous (n,)")
    build.check(build.entry("epoch", "epoch_sweep_b", 15)(
        ctypes.addressof(_kernel_params(cfg)), *_sweep_b_args(st), scal.data_ptr(),
        bal_mid.data_ptr(), eject.data_ptr(), cums.data_ptr(), rank_ok.data_ptr(),
        st.num_validators, build.stream_ptr(scal)), "epoch_sweep_b")


def epoch_finalize(cfg: EpochConfig, st: EpochState, scal: torch.Tensor) -> torch.Tensor:
    """K3's finalize (`epoch_finalize`): the slashings and randao resets in
    place, and the (3 + len(DIRTY_TRACKED),) bool aux. Kernel on CUDA,
    plain on the CPU."""
    if is_cpu(st.balances):
        return epoch_finalize_plain(cfg, st, scal)
    aux = torch.empty(3 + len(DIRTY_TRACKED), dtype=torch.bool, device=st.device)
    build.check(build.entry("epoch", "epoch_finalize", 5)(
        ctypes.addressof(_kernel_params(cfg)), st.slashings.data_ptr(),
        st.randao_mixes.data_ptr(), scal.data_ptr(), aux.data_ptr(), 0,
        build.stream_ptr(scal)), "epoch_finalize")
    return aux


def sharded_epoch_step(cfg: EpochConfig, st: EpochState, comm) -> EpochAux:
    """One `process_epoch` over this rank's block of a registry sharded over
    `comm` (parallel/mesh.MeshComm), in place; every rank calls it at once.
    The phases of K3 with three gathers where the ranks must agree:

    1. reduce this block;
    2. gather the w scal vectors, combine (stage 0): the global sums;
    3. scalars + sweep A (the scalars are the same on every rank);
    4. gather scal, this block's eject count and activation keys, combine
       (stage 1): the global frontier count;
    5. exit queue positions: the local cumsum plus the earlier ranks' counts;
    6. the activation order: one stable sort of the gathered keys (blocks
       are contiguous and in rank order, so ties break by global index, as
       the single-device sort does);
    7. mark over the global order, keeping this block's rank_ok;
    8. sweep B; gather scal and combine (stage 2): the global dirty bits;
    9. finalize on the replicated vectors.

    On CPU tensors each phase runs its plain version."""
    n = st.num_validators
    dev = st.device
    scal, bal_mid, eject, key = _buffers(n, dev)
    epoch_reduce(cfg, st, scal)
    scal = epoch_combine(comm.all_gather(scal), 0)
    epoch_sweep_a(cfg, st, scal, bal_mid, eject, key)
    count = eject.sum(dtype=torch.int64).reshape(1)
    got = comm.all_gather(torch.cat([scal, count, key]))
    scal = epoch_combine(got[:, :_N_SCAL], 1)
    cums = torch.cumsum(eject, 0) + got[:comm.rank, _N_SCAL].sum()
    order = torch.sort(got[:, _N_SCAL + 1:].reshape(-1), stable=True).indices
    rank_ok = torch.empty(order.shape[0], dtype=torch.uint8, device=dev)
    epoch_mark(order, scal, rank_ok)
    lo = comm.rank * n
    epoch_sweep_b(cfg, st, scal, bal_mid, eject, cums, rank_ok[lo:lo + n])
    scal = epoch_combine(comm.all_gather(scal), 2)
    return EpochAux.from_flat(epoch_finalize(cfg, st, scal))


def make_epoch_fn(cfg: EpochConfig, mesh=None):
    """`process_epoch(EpochState) -> (EpochState, EpochAux)` for cfg. The
    state is updated in place and returned. Kernel K3 on CUDA tensors, the
    plain version on CPU tensors.

    With `mesh` (a DeviceMesh of parallel/mesh.py or parallel/multihost.py)
    the state is this rank's shard (`shard_epoch_state`) and the step is
    `sharded_epoch_step`; the aux is the whole registry's, on every rank."""
    if mesh is not None:
        from ..parallel.mesh import MeshComm

        comm = MeshComm(mesh)

        def process_epoch_sharded(st: EpochState):
            return st, sharded_epoch_step(cfg, st, comm)

        return process_epoch_sharded

    def process_epoch(st: EpochState):
        if is_cpu(st.balances):
            new, aux = process_epoch_plain(cfg, st)
            return st.copy_(new), aux
        return st, epoch_sweep(cfg, st)

    return process_epoch
