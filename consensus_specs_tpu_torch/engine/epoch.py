"""The altair `process_epoch` over the struct-of-arrays registry
(counterpart of engine/epoch.py).

`make_epoch_fn(cfg)` returns `process_epoch(state) -> (state, aux)`, which
updates `state` IN PLACE and returns it (the JAX program donates its input
instead). On CUDA tensors it runs kernel K3 (csrc/epoch.cu) as a fixed
sequence of launches with no host sync; on CPU tensors it runs
`process_epoch_plain`, the same program in plain PyTorch, and copies the
result into `state`.

    spec function                       here
    ----------------------------------  -----------------------------------
    process_justification_and_final...  K3 scalars step / _justification_...
    process_inactivity_updates          K3 sweep A / _inactivity_updates
    process_rewards_and_penalties       K3 sweep A / _rewards_and_penalties
    process_registry_updates            K3 sweep A+B with cumsum and sort
                                        glue / _registry_updates
    process_slashings                   K3 sweep B / _slashings
    process_effective_balance_updates   K3 sweep B / _effective_balance_...
    slashings / randao resets, flag     K3 finalize / inline
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
from functools import lru_cache

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
# Plain version


def _has_flag(part: torch.Tensor, flag_index: int) -> torch.Tensor:
    bit = 1 << flag_index
    return (part & bit) == bit


def process_epoch_plain(cfg: EpochConfig, st: EpochState):
    """The JAX `process_epoch` in plain PyTorch: returns a NEW
    (EpochState, EpochAux) and leaves `st` untouched. Scalars are Python
    ints in u64 wrap arithmetic; columns are int64 (domain above)."""
    dev = st.device
    n = st.num_validators
    EBI = cfg.effective_balance_increment
    WD = cfg.weight_denominator
    i64 = as_i64

    slot = as_u64(int(st.slot))
    cur = slot // cfg.slots_per_epoch
    prev = cur - 1 if cur > cfg.genesis_epoch else cfg.genesis_epoch
    nxt = (cur + 1) & U64

    def is_active(act, ext, epoch):
        return ule(act, epoch) & ult(epoch, ext)

    def total_balance(mask, eff) -> int:
        s = as_u64(int(torch.where(mask, eff, 0).sum()))
        return max(s, EBI)

    act, ext = st.activation_epoch, st.exit_epoch
    eff, slashed = st.effective_balance, st.slashed
    active_cur = is_active(act, ext, cur)
    active_prev = is_active(act, ext, prev)
    tab = total_balance(active_cur, eff)

    # -- process_justification_and_finalization ----------------------------
    just_bits = st.justification_bits.clone()
    pj_e, pj_r = st.prev_justified_epoch.clone(), st.prev_justified_root.clone()
    cj_e, cj_r = st.curr_justified_epoch.clone(), st.curr_justified_root.clone()
    f_e, f_r = st.finalized_epoch.clone(), st.finalized_root.clone()
    if cur > cfg.genesis_epoch + 1:
        tflag = cfg.timely_target_flag_index
        prev_target = total_balance(
            active_prev & ~slashed & _has_flag(st.prev_participation, tflag), eff)
        curr_target = total_balance(
            active_cur & ~slashed & _has_flag(st.curr_participation, tflag), eff)
        old_pj = as_u64(int(st.prev_justified_epoch))
        old_cj = as_u64(int(st.curr_justified_epoch))
        bits = [False] + [bool(b) for b in st.justification_bits[:3].tolist()]
        new_j, new_jr = old_cj, st.curr_justified_root

        def block_root_at(epoch):
            return st.block_roots[(epoch * cfg.slots_per_epoch & U64) % cfg.slots_per_historical_root]

        if (prev_target * 3) & U64 >= (tab * 2) & U64:
            new_j, new_jr = prev, block_root_at(prev)
            bits[1] = True
        if (curr_target * 3) & U64 >= (tab * 2) & U64:
            new_j, new_jr = cur, block_root_at(cur)
            bits[0] = True
        fin, fin_r = as_u64(int(st.finalized_epoch)), st.finalized_root
        rules = [
            (bits[1] and bits[2] and bits[3], (old_pj + 3) & U64 == cur, old_pj, st.prev_justified_root),
            (bits[1] and bits[2], (old_pj + 2) & U64 == cur, old_pj, st.prev_justified_root),
            (bits[0] and bits[1] and bits[2], (old_cj + 2) & U64 == cur, old_cj, st.curr_justified_root),
            (bits[0] and bits[1], (old_cj + 1) & U64 == cur, old_cj, st.curr_justified_root),
        ]
        for bits_ok, dist_ok, e, r in rules:
            if bits_ok and dist_ok:
                fin, fin_r = e, r
        pj_e.fill_(i64(old_cj))
        pj_r.copy_(st.curr_justified_root)
        cj_e.fill_(i64(new_j))
        cj_r.copy_(new_jr)
        just_bits.copy_(torch.tensor(bits, device=dev))
        f_e.fill_(i64(fin))
        f_r.copy_(fin_r)
    fin_epoch = as_u64(int(f_e))

    run = cur > cfg.genesis_epoch
    eligible = active_prev | (slashed & ult(prev + 1, st.withdrawable_epoch))
    leak = ((prev - fin_epoch) & U64) > cfg.min_epochs_to_inactivity_penalty
    target_part = (active_prev & ~slashed
                   & _has_flag(st.prev_participation, cfg.timely_target_flag_index))

    # -- process_inactivity_updates ----------------------------------------
    score = st.inactivity_scores
    if run:
        score = torch.where(eligible & target_part, score - torch.clamp(score, max=1), score)
        score = torch.where(eligible & ~target_part, score + cfg.inactivity_score_bias, score)
        if not leak:
            recovery = torch.clamp(score, max=cfg.inactivity_score_recovery_rate)
            score = torch.where(eligible, score - recovery, score)

    # -- process_rewards_and_penalties -------------------------------------
    bal = st.balances
    if run:
        active_increments = tab // EBI
        brpi = (EBI * cfg.base_reward_factor) // _isqrt_u64(tab)
        base_reward = (eff // EBI) * brpi
        deltas = []
        for flag_index, weight in enumerate(cfg.participation_flag_weights):
            participating = active_prev & ~slashed & _has_flag(st.prev_participation, flag_index)
            up_increments = total_balance(participating, eff) // EBI
            if leak:
                reward = torch.zeros_like(base_reward)
            else:
                reward = torch.where(
                    eligible & participating,
                    base_reward * weight * up_increments // i64((active_increments * WD) & U64),
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

    # -- process_registry_updates ------------------------------------------
    churn = max(cfg.min_per_epoch_churn_limit, int(active_cur.sum()) // cfg.churn_limit_quotient)
    elig_for_queue = (st.activation_eligibility_epoch == FAR) & (eff == cfg.max_effective_balance)
    aee = torch.where(elig_for_queue, i64(cur + 1), st.activation_eligibility_epoch)
    eject = active_cur & ule(eff, cfg.ejection_balance) & (ext == FAR)
    act_exit = cur + 1 + cfg.max_seed_lookahead
    has_exit = ext != FAR
    frontier = max(as_u64(int(umax_reduce(torch.where(has_exit, ext, 0)))), act_exit)
    frontier_count = int((ext == i64(frontier)).sum())
    avail0 = churn - frontier_count if churn > frontier_count else 0
    qpos = torch.cumsum(eject.to(torch.int64), 0) - 1  # queue position of each ejected validator
    assigned = torch.where(ult(qpos, avail0), i64(frontier),
                           i64(frontier + 1) + (qpos - avail0) // churn)
    new_exit = torch.where(eject, assigned, ext)
    new_wd = torch.where(eject, assigned + cfg.min_validator_withdrawability_delay,
                         st.withdrawable_epoch)
    elig_act = ule(aee, fin_epoch) & (act == FAR)
    key = torch.where(elig_act, aee, FAR)
    order = torch.sort(sort_key(key), stable=True).indices  # == lexsort((idx, key))
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=dev))
    new_act = torch.where(elig_act & (rank < churn), i64(act_exit), act)

    # -- process_slashings -------------------------------------------------
    # total active balance over the post-registry columns, as in the JAX
    # program (it equals `tab`: new activations and exits lie after `cur`)
    tab_s = total_balance(is_active(new_act, new_exit, cur), eff)
    adjusted = min((as_u64(int(st.slashings.sum())) * cfg.proportional_slashing_multiplier) & U64,
                   tab_s)
    hit = slashed & (new_wd == i64(cur + cfg.epochs_per_slashings_vector // 2))
    penalty = torch.where(hit, eff // EBI * adjusted // tab_s * EBI, 0)
    bal = bal - torch.minimum(penalty, bal)

    # -- process_effective_balance_updates ---------------------------------
    hyst = EBI // cfg.hysteresis_quotient
    down = hyst * cfg.hysteresis_downward_multiplier
    up = hyst * cfg.hysteresis_upward_multiplier
    moved = ult(bal + down, eff) | ult(eff + up, bal)
    new_eff = torch.where(moved, torch.clamp(bal - bal % EBI, max=cfg.max_effective_balance), eff)

    # -- slashings reset, randao mixes reset, participation rotation -------
    slashings = st.slashings.clone()
    slashings[nxt % cfg.epochs_per_slashings_vector] = 0
    mixes = st.randao_mixes.clone()
    ephv = cfg.epochs_per_historical_vector
    mixes[nxt % ephv] = st.randao_mixes[cur % ephv]

    out = EpochState(
        slot=st.slot.clone(),
        balances=bal,
        effective_balance=new_eff,
        activation_eligibility_epoch=aee,
        activation_epoch=new_act,
        exit_epoch=new_exit,
        withdrawable_epoch=new_wd,
        slashed=slashed.clone(),
        prev_participation=st.curr_participation.clone(),
        curr_participation=torch.zeros_like(st.curr_participation),
        inactivity_scores=score,
        slashings=slashings,
        randao_mixes=mixes,
        block_roots=st.block_roots.clone(),
        state_roots=st.state_roots.clone(),
        justification_bits=just_bits,
        prev_justified_epoch=pj_e,
        prev_justified_root=pj_r,
        curr_justified_epoch=cj_e,
        curr_justified_root=cj_r,
        finalized_epoch=f_e,
        finalized_root=f_r,
    )
    epochs_per_batch = cfg.slots_per_historical_root // cfg.slots_per_epoch
    flags = torch.tensor([nxt % epochs_per_batch == 0,
                          nxt % cfg.epochs_per_eth1_voting_period == 0,
                          nxt % cfg.epochs_per_sync_committee_period == 0], device=dev)
    dirty = torch.stack([(getattr(out, name) != getattr(st, name)).any()
                         for name in DIRTY_TRACKED])
    return out, EpochAux.from_flat(torch.cat([flags, dirty]))


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


_N_SCAL = 32  # device scalar slots (u64 scal[32] in csrc/epoch.cu)
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


def epoch_sweep(cfg: EpochConfig, st: EpochState) -> EpochAux:
    """Kernel K3: one `process_epoch` over CUDA tensors, in place. Launch
    sequence: reduce -> scalars -> sweep A, then cumsum and stable-sort glue,
    then mark -> sweep B -> finalize. No host sync.

    Overwrites in place: the ten registry columns, `slashings` (one row),
    `randao_mixes` (one row), `justification_bits` and the three
    checkpoints. `slot` is read, not advanced."""
    _check_state(cfg, st)
    params = _kernel_params(cfg)
    ckpts = (ctypes.c_void_p * 6)(
        st.prev_justified_epoch.data_ptr(), st.prev_justified_root.data_ptr(),
        st.curr_justified_epoch.data_ptr(), st.curr_justified_root.data_ptr(),
        st.finalized_epoch.data_ptr(), st.finalized_root.data_ptr())
    n = st.num_validators
    dev = st.device
    stream = build.stream_ptr(st.balances)
    scal = torch.empty(_N_SCAL, dtype=torch.int64, device=dev)
    bal_mid = torch.empty(n, dtype=torch.int64, device=dev)
    eject = torch.empty(n, dtype=torch.uint8, device=dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
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


def make_epoch_fn(cfg: EpochConfig):
    """`process_epoch(EpochState) -> (EpochState, EpochAux)` for cfg. The
    state is updated in place and returned. Kernel K3 on CUDA tensors, the
    plain version on CPU tensors."""

    def process_epoch(st: EpochState):
        if is_cpu(st.balances):
            new, aux = process_epoch_plain(cfg, st)
            return st.copy_(new), aux
        return st, epoch_sweep(cfg, st)

    return process_epoch
