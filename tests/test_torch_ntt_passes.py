"""K22's passes through shared memory (csrc/ntt.cu `fr_ntt_pass`) mirrored
on the CPU with the plain field (ops/fr.py `fr_mul`, `fr_add`, `fr_sub`)
and the kernel's own index math: pass A's tile gathered at bit-reversed
positions, a later pass's column groups, the twiddle index c + (m mod
2^(s - s0))·2^s0 of the flat table, the constant rows `pre` (first pass)
and `post` (last stage), and the outputs written where the last stage
writes them. The mirror runs the plan `ops/fr.ntt_passes` gives the
kernel, and is held equal to `ntt_plain` and to JAX's `make_ntt`
(consensus_specs_tpu/ops/fr_jax.py:106) on numpy-seeded inputs with the
edge values 0, 1 and r - 1.

The DAS path's entries are held here too: `ntt_words` (canonical words in
and out, the conversions folded into K22) against `ntt_ints`, the host
DFT and JAX's ints_to_mont_batch -> make_ntt -> mont_batch_to_ints, and
K23's `OP_INV_WORDS` against pow(x, r - 2, r)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fr_jax
from consensus_specs_tpu_torch.ops import fr
from consensus_specs_tpu_torch.ops.fr_host import R_MODULUS, host_ntt

JAX_N = 1 << 10  # JAX's make_ntt compiles slowly on the CPU: one size, both directions
EDGES = [0, 1, R_MODULUS - 1, fr.R_MOD_R]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_ntts():
    return {inv: fr_jax.make_ntt(JAX_N, inverse=inv) for inv in (False, True)}


def _ints(seed, m, top=R_MODULUS):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % top for _ in range(m)]
    return (EDGES + rand)[:m]


def _words(seed, shape, top=R_MODULUS):
    m = int(np.prod(shape))
    return torch.from_numpy(fr.ints_to_words(_ints(seed, m, top))).reshape(*shape, fr.NWORDS)


def _rev(idx: torch.Tensor, logn: int) -> torch.Tensor:
    out = torch.zeros_like(idx)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


def mirror_ntt(values: torch.Tensor, inverse: bool, t: int, pre=None, post=None):
    """K22 on (B, n, 8) words as csrc/ntt.cu runs it, every block of a pass
    at once: `pre` and `post` are (8,) words or None, as the entry's."""
    lim = fr.to_limbs(values)
    n = values.shape[-2]
    logn = n.bit_length() - 1
    table, _ = fr.twiddles(n, inverse, "cpu")
    tw = fr.to_limbs(table)
    src, out = lim, torch.empty_like(lim)
    if logn == 0:
        x = lim
        for row in (pre, post):
            if row is not None:
                x = fr.fr_mul(x, fr.to_limbs(row))
        return fr.to_words(x)
    for s0, s1, logc in fr.ntt_passes(logn, t):
        g = s1 - s0 + logc
        assert g <= fr.NTT_GROUP_LOG
        grp = torch.arange(n >> g)
        hi_part = (grp >> (s0 - logc)) << s1
        lo0 = (grp & ((1 << (s0 - logc)) - 1)) << logc
        e = torch.arange(1 << g)
        cmask = (1 << logc) - 1
        idx = hi_part[:, None] + ((e >> logc) << s0)[None] + lo0[:, None] + (e & cmask)[None]
        sh = src[:, _rev(idx, logn) if s0 == 0 else idx]  # (B, groups, 2^g, 16)
        if s0 == 0 and pre is not None:
            sh = fr.fr_mul(sh, fr.to_limbs(pre))
        k = torch.arange(1 << (g - 1))
        c, q = k & cmask, k >> logc
        for s in range(s0, s1):
            ls, h = s - s0, 1 << (s - s0)
            m0 = ((q >> ls) << (ls + 1)) + (q & (h - 1))
            e0 = (m0 << logc) + c
            e1 = e0 + (h << logc)
            j = ((q & (h - 1)) << s0)[None] + lo0[:, None] + c[None]
            p = fr.fr_mul(sh[:, :, e1], tw[(1 << s) - 1 + j])
            y0, y1 = fr.fr_add(sh[:, :, e0], p), fr.fr_sub(sh[:, :, e0], p)
            if s + 1 < s1:
                sh = sh.clone()
                sh[:, :, e0], sh[:, :, e1] = y0, y1
            else:
                if s1 == logn and post is not None:
                    y0, y1 = fr.fr_mul(y0, fr.to_limbs(post)), fr.fr_mul(y1, fr.to_limbs(post))
                i0 = hi_part[:, None] + (m0 << s0)[None] + lo0[:, None] + c[None]
                out = out.clone()
                out[:, i0], out[:, i0 + (1 << s)] = y0, y1
        src = out
    return fr.to_words(out)


def _canonical_rows(n, inverse):
    post = fr._inverse_n(n, "cpu") if inverse else fr.const_row(1, "cpu")
    return fr.const_row(fr.R2_MOD_R, "cpu"), post


def _jax_words(fn, x: torch.Tensor) -> torch.Tensor:
    from consensus_specs_tpu_torch.engine.convert import fp_from_jax_limbs, fp_to_jax_limbs

    return fp_from_jax_limbs(np.asarray(fn(fp_to_jax_limbs(x))))


def test_plan_covers_every_stage_once():
    """The plan's passes tile the stages in order, pass A on contiguous
    tiles, every group within the kernel's 1,024 elements; the DAS widths
    take two grids, n <= 2^t one, n = 2^(t+1) a pass B of one stage."""
    for logn in range(1, 21):
        t = fr.ntt_tile_log(1 << logn)
        passes = fr.ntt_passes(logn, t)
        assert passes[0] == (0, t, 0)
        assert [p[0] for p in passes[1:]] == [p[1] for p in passes[:-1]]
        assert passes[-1][1] == logn
        assert all(s1 - s0 + logc <= fr.NTT_GROUP_LOG for s0, s1, logc in passes)
    assert fr.ntt_passes(14, 8) == [(0, 8, 0), (8, 14, 2)]
    assert fr.ntt_passes(15, 8) == [(0, 8, 0), (8, 15, 2)]
    assert fr.ntt_passes(8, 8) == [(0, 8, 0)]
    assert fr.ntt_passes(9, 8) == [(0, 8, 0), (8, 9, 2)]
    assert fr.ntt_passes(17, 8) == [(0, 8, 0), (8, 16, 2), (16, 17, 2)]
    assert fr.ntt_passes(5, 1) == [(0, 1, 0), (1, 5, 1)]


def test_plan_constants_match_the_kernel():
    text = (Path(fr.__file__).parents[1] / "csrc" / "ntt.cu").read_text()
    for name in ("NTT_PASS_STAGES", "NTT_COLS_LOG", "NTT_GROUP_LOG"):
        assert int(re.search(rf"#define {name} (\d+)", text).group(1)) == getattr(fr, name)
    assert fr.NTT_TILE_LOG <= fr.NTT_GROUP_LOG


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("logn", range(1, 11))
def test_mirror_at_every_tile_log_matches_plain(jax_ntts, logn, inverse):
    """Every t from 1 to log2 n: pass A alone at t = log2 n, a pass B of one
    stage at t = log2 n - 1; at n = 2^10 also JAX's make_ntt."""
    n = 1 << logn
    x = _words(logn + 50 * inverse, (2 if logn < 9 else 1, n))
    want = fr.ntt_plain(x, inverse)
    if n == JAX_N:
        assert torch.equal(want, _jax_words(jax_ntts[inverse], x))
    scale = fr.twiddles(n, inverse, "cpu")[1]
    for t in range(1, logn + 1):
        assert torch.equal(mirror_ntt(x, inverse, t, post=scale), want), t


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("logn", [0, 11, 12])
def test_mirror_at_the_wrappers_split_matches_plain(logn, inverse):
    n = 1 << logn
    x = _words(logn + 7 + inverse, (1, n))
    scale = fr.twiddles(n, inverse, "cpu")[1]
    got = mirror_ntt(x, inverse, fr.ntt_tile_log(n), post=scale)
    assert torch.equal(got, fr.ntt_plain(x, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_canonical_entry_matches_jax_and_ntt_ints(jax_ntts, inverse):
    """`ntt_words` (its plain version here) and the mirror with its constant
    rows against `ntt_ints` on the CPU and JAX's conversions around
    make_ntt; inputs 0, 1, r - 1 and words at or above r."""
    ints = _ints(70 + inverse, JAX_N)
    ints[4:8] = [R_MODULUS, R_MODULUS + 1, (1 << 256) - 1, 2 * R_MODULUS - 1]
    reduced = [v % R_MODULUS for v in ints]
    words = torch.from_numpy(fr.ints_to_words(ints)).reshape(1, JAX_N, fr.NWORDS)
    got = fr.ntt_words(words, inverse)
    assert torch.equal(got, fr.ntt_words_plain(words, inverse))
    jax_out = jax_ntts[inverse](fr_jax.ints_to_mont_batch(reduced))
    want = fr_jax.mont_batch_to_ints(np.asarray(jax_out))
    assert fr.words_to_ints(got) == want
    assert fr.ntt_ints(ints, inverse, "cpu") == want
    pre, post = _canonical_rows(JAX_N, inverse)
    assert torch.equal(mirror_ntt(words, inverse, fr.ntt_tile_log(JAX_N), pre, post), got)


@pytest.mark.parametrize("logn", [0, 1, 3, 6])
def test_canonical_entry_matches_the_host_dft(logn):
    n = 1 << logn
    ints = _ints(80 + logn, 3 * n, top=1 << 256)
    words = torch.from_numpy(fr.ints_to_words(ints)).reshape(3, n, fr.NWORDS)
    for inverse in (False, True):
        got = fr.ntt_words(words, inverse)
        rows = [[v % R_MODULUS for v in ints[i * n:(i + 1) * n]] for i in range(3)]
        assert fr.words_to_ints(got) == [v for r in rows for v in host_ntt(r, inverse=inverse)]
        pre, post = _canonical_rows(n, inverse)
        for t in sorted({max(1, logn - 1), max(1, logn)} if logn else {0}):
            assert torch.equal(mirror_ntt(words, inverse, t, pre, post), got)


def test_inverse_of_words_matches_pow():
    """K23 `OP_INV_WORDS` (plain version): canonical in and out, zero to
    zero, words at or above r reduced; `inv_ints` on the CPU alike."""
    ints = _ints(90, 40) + [R_MODULUS, R_MODULUS + 3, (1 << 256) - 1]
    words = torch.from_numpy(fr.ints_to_words(ints))
    got = fr.words_to_ints(fr.fr_ops(fr.OP_INV_WORDS, words))
    want = [pow(v % R_MODULUS, R_MODULUS - 2, R_MODULUS) for v in ints]
    assert got == want and got[0] == 0
    assert fr.inv_ints(ints, "cpu") == want
    mont = fr.fr_ops(fr.OP_INV, fr.ints_to_mont(ints, "cpu"))
    assert fr.mont_to_ints(mont) == want


def test_constant_rows_are_cached_per_device():
    assert fr.const_row(fr.R2_MOD_R, "cpu") is fr.const_row(fr.R2_MOD_R, "cpu")
    assert fr.words_to_ints(fr._inverse_n(1 << 14, "cpu")) == [
        pow(1 << 14, R_MODULUS - 2, R_MODULUS)]
    assert fr.twiddles(64, True, "cpu")[1] is fr.const_row(
        pow(64, R_MODULUS - 2, R_MODULUS) * fr.R % R_MODULUS, "cpu")
