"""Host bridge: a spec `BeaconState` (the port's SSZ objects) <-> the
device `EpochState` (counterpart of engine/bridge.py).

`apply_epoch_via_engine(spec, state)` replaces the spec's
`process_epoch(state)` (specs/altair/beacon-chain.md): transpose the state
to struct-of-arrays tensors, run the epoch program (kernel K3 on CUDA, its
plain version on the CPU), write the mutated columns back, and perform the
three epilogues the device flags through `EpochAux`:
- the eth1 vote list reset;
- the historical append: hash_tree_root(HistoricalBatch) through kernel
  K19 (`epoch.historical_append_root`), where the JAX package sends the
  same tree through its scheduler's Merkle lane (engine/bridge.py:49);
  `epoch.historical_batch_root` stays the oracle the tests hold it to;
- the sync-committee rotation: the sampler on the device
  (`sync_committee.next_sync_committee_indices`, K4 + K5) and the spec's
  `eth_aggregate_pubkeys`, which validates each key (`bls.KeyValidate`)
  and sums them through the port shim's `AggregatePKs` (K10).

The write-back is two-phase and dirty-aware, as in the JAX package: staging
copies to the host only the columns `EpochAux.dirty_cols` flags, and of
the randao mixes only the row the epoch writes (next_epoch %
EPOCHS_PER_HISTORICAL_VECTOR); the commit then touches only the validators
whose registry fields changed and adopts whole-registry lists as the SSZ
lists' columnar backing (`from_numpy`).

Not here yet (ROADMAP A4(a)): the retry, breaker and degrade path of the
JAX bridge (engine/bridge.py:380-517). A device failure propagates; an
epoch never degrades to `spec.process_epoch`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.sha256_host import bytes_to_words, words_to_bytes
from ..ops.shuffle import seed_words_tensor
from ..utils.device import resolve_device
from ..utils.u64 import as_i64, as_u64
from .epoch import historical_append_root, make_epoch_fn
from .state import DIRTY_TRACKED, EpochConfig, EpochState
from .sync_committee import next_sync_committee_indices


def _roots_to_words(roots) -> np.ndarray:
    """A sequence of 32-byte roots -> (n, 8) uint32 big-endian words."""
    return bytes_to_words(b"".join(bytes(r) for r in roots)).reshape(len(roots), 8)


def _words_to_root(words) -> bytes:
    return words_to_bytes(np.asarray(words))


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host column as an OWNED tensor on dev (uint64 -> int64 and uint32
    -> int32 bit patterns): the epoch program works in place, and on the CPU
    a shared buffer would scribble the memoized columns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev, copy=True)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy of a device column, in the SSZ lists' dtypes."""
    a = t.detach().to("cpu", copy=True).numpy()
    if a.dtype == np.int64:
        return a.view(np.uint64)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a


def _validator_columns(vals) -> dict[str, np.ndarray]:
    """One C-driven pass per field over the validator containers."""
    n = len(vals)
    f = np.fromiter
    return {
        "effective_balance": f((v.effective_balance for v in vals), np.uint64, count=n),
        "activation_eligibility_epoch": f(
            (v.activation_eligibility_epoch for v in vals), np.uint64, count=n),
        "activation_epoch": f((v.activation_epoch for v in vals), np.uint64, count=n),
        "exit_epoch": f((v.exit_epoch for v in vals), np.uint64, count=n),
        "withdrawable_epoch": f((v.withdrawable_epoch for v in vals), np.uint64, count=n),
        "slashed": f((v.slashed for v in vals), np.bool_, count=n),
    }


def _cached_validator_columns(vals) -> dict[str, np.ndarray]:
    """Validator columns memoized on the registry object, keyed by its SSZ
    root (incremental, so the check costs little); the write-back refreshes
    the memo in place, so consecutive epochs hit (engine/bridge.py:90)."""
    key = vals.hash_tree_root()
    cached = vals.__dict__.get("_engine_cols")
    if cached is not None and cached[0] == key:
        return cached[1]
    cols = _validator_columns(vals)
    vals.__dict__["_engine_cols"] = (key, cols)
    return cols


def state_to_device_with_columns(spec, state, device="cuda"):
    """(EpochState on `device`, EpochConfig, host validator columns): the
    epoch-relevant slice of a spec BeaconState (engine/bridge.py:105). The
    columns are the diff base of the write-back."""
    dev = resolve_device(device)
    cfg = EpochConfig.from_spec(spec)
    cols = _cached_validator_columns(state.validators)

    def scalar(v):
        return torch.tensor(as_i64(int(v)), dtype=torch.int64, device=dev)

    def root(r):
        return _to_device(_roots_to_words([r])[0], dev)

    st = EpochState(
        slot=scalar(state.slot),
        balances=_to_device(state.balances.to_numpy(), dev),
        effective_balance=_to_device(cols["effective_balance"], dev),
        activation_eligibility_epoch=_to_device(cols["activation_eligibility_epoch"], dev),
        activation_epoch=_to_device(cols["activation_epoch"], dev),
        exit_epoch=_to_device(cols["exit_epoch"], dev),
        withdrawable_epoch=_to_device(cols["withdrawable_epoch"], dev),
        slashed=_to_device(cols["slashed"], dev),
        prev_participation=_to_device(state.previous_epoch_participation.to_numpy(), dev),
        curr_participation=_to_device(state.current_epoch_participation.to_numpy(), dev),
        inactivity_scores=_to_device(state.inactivity_scores.to_numpy(), dev),
        slashings=_to_device(state.slashings.to_numpy(), dev),
        randao_mixes=_to_device(_roots_to_words(state.randao_mixes), dev),
        block_roots=_to_device(_roots_to_words(state.block_roots), dev),
        state_roots=_to_device(_roots_to_words(state.state_roots), dev),
        justification_bits=torch.tensor([bool(b) for b in state.justification_bits],
                                        device=dev),
        prev_justified_epoch=scalar(state.previous_justified_checkpoint.epoch),
        prev_justified_root=root(state.previous_justified_checkpoint.root),
        curr_justified_epoch=scalar(state.current_justified_checkpoint.epoch),
        curr_justified_root=root(state.current_justified_checkpoint.root),
        finalized_epoch=scalar(state.finalized_checkpoint.epoch),
        finalized_root=root(state.finalized_checkpoint.root),
    )
    return st, cfg, cols


def state_to_device(spec, state, device="cuda") -> tuple:
    st, cfg, _ = state_to_device_with_columns(spec, state, device)
    return st, cfg


def write_back_full_bytes(dev: EpochState) -> int:
    """Bytes a full materialization moves to the host: every DIRTY_TRACKED
    column."""
    return sum(getattr(dev, name).numel() * getattr(dev, name).element_size()
               for name in DIRTY_TRACKED)


_REGISTRY_FIELDS = ("effective_balance", "activation_eligibility_epoch", "activation_epoch",
                    "exit_epoch", "withdrawable_epoch", "slashed")
_BULK_FIELDS = {
    "balances": "balances",
    "inactivity_scores": "inactivity_scores",
    "prev_participation": "previous_epoch_participation",
    "curr_participation": "current_epoch_participation",
    "slashings": "slashings",
}


def _stage_write_back(spec, state, dev: EpochState, pre_cols: dict, dirty: dict,
                      mix_row: int) -> dict:
    """Phase 1 (engine/bridge.py:172): every device-to-host copy and diff,
    no mutation of the host state. Columns that `dirty` marks clean stay
    on the device; of the randao mixes only row `mix_row` is gathered."""
    staged: dict = {"registry": [], "bulk": [], "clean": [], "moved": 0,
                    "full": write_back_full_bytes(dev), "mix": None}
    types = {"effective_balance": spec.Gwei, "slashed": spec.boolean}
    for name in _REGISTRY_FIELDS:
        if not dirty[name]:
            staged["clean"].append(name)
            continue
        post = _to_host(getattr(dev, name))
        staged["moved"] += post.nbytes
        changed = np.nonzero(post != pre_cols[name])[0]
        staged["registry"].append((name, types.get(name, spec.Epoch), changed.tolist(),
                                   post[changed].tolist(), post))
    for dev_name, state_name in _BULK_FIELDS.items():
        if not dirty[dev_name]:
            staged["clean"].append(dev_name)
            continue
        post = _to_host(getattr(dev, dev_name))
        staged["moved"] += post.nbytes
        staged["bulk"].append((state_name, post))
    if not dirty["randao_mixes"]:
        staged["clean"].append("randao_mixes")
    else:
        row = _to_host(dev.randao_mixes[mix_row])
        staged["moved"] += row.nbytes
        staged["mix"] = (mix_row, row)
    staged["justification_bits"] = _to_host(dev.justification_bits)
    staged["checkpoints"] = tuple(
        (as_u64(int(getattr(dev, f"{p}_epoch"))),
         _words_to_root(_to_host(getattr(dev, f"{p}_root"))))
        for p in ("prev_justified", "curr_justified", "finalized"))
    return staged


def _commit_write_back(spec, state, staged: dict, pre_cols: dict) -> dict:
    """Phase 2 (engine/bridge.py:267): swap the staged buffers into the SSZ
    object tree and the diff base; host memory only."""
    vals = state.validators
    for name, typ, idxs, values, post in staged["registry"]:
        for i, value in zip(idxs, values):
            setattr(vals[i], name, typ(value))
        pre_cols[name] = post  # keep the memoized columns post-epoch coherent
    for state_name, post in staged["bulk"]:
        cur = getattr(state, state_name)
        setattr(state, state_name, type(cur).from_numpy(post))
    if staged["mix"] is not None:
        row, words = staged["mix"]
        state.randao_mixes[row] = spec.Bytes32(_words_to_root(words))
    for i, b in enumerate(staged["justification_bits"]):
        state.justification_bits[i] = bool(b)
    (pj, pjr), (cj, cjr), (fi, fir) = staged["checkpoints"]
    state.previous_justified_checkpoint = spec.Checkpoint(epoch=spec.Epoch(pj), root=spec.Root(pjr))
    state.current_justified_checkpoint = spec.Checkpoint(epoch=spec.Epoch(cj), root=spec.Root(cjr))
    state.finalized_checkpoint = spec.Checkpoint(epoch=spec.Epoch(fi), root=spec.Root(fir))
    # re-key the memoized columns to the post-epoch registry root
    vals.__dict__["_engine_cols"] = (vals.hash_tree_root(), pre_cols)
    return {"moved_bytes": staged["moved"], "full_bytes": staged["full"],
            "clean_cols": staged["clean"]}


def install_next_sync_committee(spec, state, active: np.ndarray, eff: np.ndarray, seed: bytes,
                                device="cuda") -> None:
    """The tail of `process_sync_committee_updates` (engine/bridge.py:345):
    sample the next committee from (active indices, effective balances,
    seed) on `device` and rotate the state's committee fields; the new
    committee's aggregate key comes from the spec's `eth_aggregate_pubkeys`
    (KeyValidate on each key, AggregatePKs through the port shim)."""
    dev = resolve_device(device)
    indices = next_sync_committee_indices(
        _to_device(np.asarray(active, dtype=np.uint64), dev),
        _to_device(np.asarray(eff, dtype=np.uint64), dev),
        seed_words_tensor(bytes(seed), dev),
        sync_committee_size=int(spec.SYNC_COMMITTEE_SIZE),
        max_effective_balance=int(spec.MAX_EFFECTIVE_BALANCE),
        shuffle_round_count=int(spec.SHUFFLE_ROUND_COUNT),
    )
    pubkeys = [state.validators[i].pubkey for i in indices.tolist()]
    state.current_sync_committee = state.next_sync_committee
    state.next_sync_committee = spec.SyncCommittee(
        pubkeys=pubkeys, aggregate_pubkey=spec.eth_aggregate_pubkeys(pubkeys))


def _rotate_sync_committees(spec, state, device="cuda") -> None:
    """`process_sync_committee_updates`' body (engine/bridge.py:366): the
    activity mask and effective balances from the memoized registry
    columns, the seed from the spec."""
    next_epoch = spec.get_current_epoch(state) + 1
    cols = _cached_validator_columns(state.validators)
    active = np.nonzero((cols["activation_epoch"] <= next_epoch)
                        & (next_epoch < cols["exit_epoch"]))[0].astype(np.uint64)
    seed = spec.get_seed(state, spec.Epoch(next_epoch), spec.DOMAIN_SYNC_COMMITTEE)
    install_next_sync_committee(spec, state, active, cols["effective_balance"], bytes(seed),
                                device)


@lru_cache(maxsize=None)
def epoch_fn_for(cfg: EpochConfig):
    return make_epoch_fn(cfg)


def apply_epoch_via_engine(spec, state, stage_timer=None, stats=None, device="cuda",
                           capture=None) -> None:
    """`process_epoch(state)` on the device, in place (engine/bridge.py:469).

    `stage_timer(name)`, if given, is called with "start" on entry and
    after each stage: "bridge_in", "device" (after a synchronize) and
    "write_back" (the epilogues included). The write-back copies only the
    columns the epoch dirtied and the one mix row it wrote. `stats`, a
    dict, receives the write-back's {"moved_bytes", "full_bytes",
    "clean_cols"}.
    `capture`, a dict, receives "cfg", "pre" (a clone of the device state
    before the epoch), "post" and "aux". Any failure propagates."""
    dev = resolve_device(device)
    tick = stage_timer or (lambda name: None)
    tick("start")
    st, cfg, pre_cols = state_to_device_with_columns(spec, state, dev)
    tick("bridge_in")
    if capture is not None:
        capture.update(cfg=cfg, pre=st.clone())
    st, aux = epoch_fn_for(cfg)(st)
    if stage_timer is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tick("device")
    if capture is not None:
        capture.update(post=st, aux=aux)
    flags = _to_host(aux.flat())
    historical_append, eth1_reset, sync_update = (bool(f) for f in flags[:3])
    dirty = {name: bool(f) for name, f in zip(DIRTY_TRACKED, flags[3:])}
    # the only mix row an epoch writes is the one of the epoch it enters
    next_epoch = int(state.slot) // int(spec.SLOTS_PER_EPOCH) + 1
    mix_row = next_epoch % int(spec.EPOCHS_PER_HISTORICAL_VECTOR)
    staged = _stage_write_back(spec, state, st, pre_cols, dirty, mix_row)
    wb = _commit_write_back(spec, state, staged, pre_cols)
    if stats is not None:
        stats.update(wb)
    if eth1_reset:
        state.eth1_data_votes = type(state.eth1_data_votes)()
    if historical_append:
        state.historical_roots.append(spec.Root(_words_to_root(_to_host(
            historical_append_root(st.block_roots, st.state_roots)))))
    if sync_update:
        _rotate_sync_committees(spec, state, dev)
    tick("write_back")
