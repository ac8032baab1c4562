// The group programs of K9 and K11 on the card: one step (a Miller loop's
// iteration, a curve double or add) on a group of units, a unit being a
// lane (limb field, csrc/fp.cuh: the group is G lanes of a warp) or a warp
// (RNS, csrc/fp_rns.cuh: G warps of a block). Included by csrc/pairing.cu
// and csrc/rlc.cu.
//
// The step's values live in the group's slots in shared memory, an Fp a
// slot (twelve words, or 64 residues), slot 0 holding zero. A program
// (generated into csrc/bls_programs.cuh by ops/bls12_programs.py, which
// also plays it over the plain fields) is a list of rounds; in a round unit
// `rank` runs the jobs rank, rank + G, ..., and the group syncs after it:
// - a product job forms its two operands, each a sum of up to six slots with
//   signs (`fp_opsum`), and multiplies them with the one-unit `fp_mul`;
// - a linear job forms the sum of up to seven slots times int8 coefficients
//   (`fp_lincomb`): limb, a sum a word and one reduction; RNS, a channel sum
//   and one fold per channel.
// A round's jobs read only slots written in earlier rounds, and write slots
// no job of the round reads (the generator's allocation), so a round needs
// no sync inside. Every linear step is exact modular arithmetic on
// canonical values in both fields, so the slots hold the one-unit code's
// words and residues (ops/bls12_programs.py).
//
// The group types, `lanes<G>` and `warps<W, PER>`, are csrc/unit_group.cuh's.
#pragma once
#include "bls_programs.cuh"
#include "curve.cuh"
#include "unit_group.cuh"

// --- the two field steps of a job -----------------------------------------------

// byte b of a job
BLS_INLINE unsigned slp_byte(const uint4 &j, int b) {
    const unsigned w = b < 4 ? j.x : b < 8 ? j.y : b < 12 ? j.z : j.w;
    return (w >> (8 * (b & 3))) & 255u;
}

BLS_INLINE const uint32_t *slot(const uint32_t *vals, unsigned s, int words) {
    return vals + s * words;
}

// a slot's value: limb, three 16-byte words (a slot is 48 bytes, the slots
// 16-byte aligned); RNS, the lane's two residues
BLS_INLINE void slot_load(fp &x, const uint32_t *p) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const uint4 v = ((const uint4 *)p)[i];
        x.w[4 * i] = v.x;
        x.w[4 * i + 1] = v.y;
        x.w[4 * i + 2] = v.z;
        x.w[4 * i + 3] = v.w;
    }
}
BLS_INLINE void slot_store(uint32_t *p, const fp &x) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
        ((uint4 *)p)[i] = make_uint4(x.w[4 * i], x.w[4 * i + 1], x.w[4 * i + 2], x.w[4 * i + 3]);
}
RNS_INLINE void slot_load(rns_w &x, const uint32_t *p) { fp_load(x, p); }
RNS_INLINE void slot_store(uint32_t *p, const rns_w &x) { fp_store(p, x); }

// sum of c_k·v_k mod p, canonical: a term with c < 0 adds |c|·(2^384 - 1 -
// v) (the words inverted) and the sum then adds (1 - 2^384) once per unit of
// the negative coefficients. Each word's sum runs in its own 64 bits (below
// 8·127·2^32), so a term is twelve independent multiply-adds and the
// carries settle once; the sum stays below 2^395, its quotient by p (below
// 2^15) is estimated from the top two words (at most one short) and one
// conditional subtraction ends it.
BLS_INLINE void fp_lincomb(fp &r, const uint4 &job, int n, const uint32_t *vals) {
    uint64_t acc[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[j] = 0;
    uint32_t negs = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
        if (k < n) {
            fp v;
            slot_load(v, slot(vals, slp_byte(job, k), 12));
            const int c = (int)(signed char)slp_byte(job, 7 + k);
            const uint32_t m = c < 0 ? 0xffffffffu : 0u, a = (uint32_t)(c < 0 ? -c : c);
            negs += m & a;
#pragma unroll
            for (int j = 0; j < 12; ++j) acc[j] += (uint64_t)a * (v.w[j] ^ m);
        }
    }
    uint32_t t[13];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        c = acc[j] + (uint64_t)negs * FP_LIN_CORR[j] + (c >> 32);
        t[j] = (uint32_t)c;
    }
    t[12] = (uint32_t)(c >> 32);
    const double hi = (double)t[12] * 4294967296.0 + (double)t[11];
    const uint32_t q = (uint32_t)(hi * FP_LIN_QINV);
    uint32_t carry = 0, borrow = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        const uint64_t qp = (uint64_t)q * FP_P[j] + carry;
        carry = (uint32_t)(qp >> 32);
        const uint64_t d = (uint64_t)t[j] - (uint32_t)qp - borrow;
        t[j] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
    }
    t[12] = t[12] - carry - borrow;
    fp_reduce_once(r, t);
}

// channel by channel: |sum| < 7·127·2^15 < m·2^11, so the sum plus m·2^11
// is positive and below 2^31, and one full fold makes it canonical
RNS_INLINE void fp_lincomb(rns_w &r, const uint4 &job, int n, const uint32_t *vals) {
    const int ma = rns_v(RV_MA), mb = rns_v(RV_MB);
    int sa = 0, sb = 0;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
        rns_w v;
        slot_load(v, slot(vals, slp_byte(job, k), RNS_N));
        const int c = (int)(signed char)slp_byte(job, 7 + k);
        sa += c * v.a;
        sb += c * v.b;
    }
    r.a = (int)rns_red_full((uint32_t)(sa + (ma << 11)), (uint32_t)ma);
    r.b = (int)rns_red_full((uint32_t)(sb + (mb << 11)), (uint32_t)mb);
}

// a product's operand term: limb, a + b or a + (p - b) left unreduced (below
// np after n terms; fp_mul's CIOS gives the canonical product for operands
// below 3p, since 9p^2 < p·2^384); RNS, fp_add or fp_sub (its products
// take canonical residues; a warp runs one job, so the branch is uniform)
BLS_INLINE void fp_opsum(fp &r, const fp &a, const fp &b, unsigned neg) {
    const bool s = neg & 1u;
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        const int64_t bj = s ? (int64_t)FP_P[j] - (int64_t)b.w[j] : (int64_t)b.w[j];
        c = (int64_t)a.w[j] + bj + (c >> 32);
        r.w[j] = (uint32_t)c;
    }
}
RNS_INLINE void fp_opsum(rns_w &r, const rns_w &x, const rns_w &y, unsigned neg) {
    if (neg & 1u)
        fp_sub(r, x, y);
    else
        fp_add(r, x, y);
}

// operand of a product job: its n signed terms from byte `off` (signs from
// bit `off` of bytes 13-14)
template <typename F>
BLS_INLINE void slp_operand(F &x, const uint4 &job, int off, int n, const uint32_t *vals) {
    const unsigned signs = slp_byte(job, 13) | slp_byte(job, 14) << 8;
    slot_load(x, slot(vals, slp_byte(job, off), F::WORDS));
#pragma unroll 1
    for (int k = 1; k < n; ++k) {
        F t;
        slot_load(t, slot(vals, slp_byte(job, off + k), F::WORDS));
        fp_opsum(x, x, t, signs >> (off + k));
    }
}

// Run the program (rounds r0 .. r0 + nr) on the group's slots. Every unit
// calls it; the slots it reads were written before a sync of the group.
template <typename F, typename Grp>
BLS_NOINLINE void slp_run(int r0, int nr, uint32_t *vals) {
    for (int r = r0; r < r0 + nr; ++r) {
        const uint2 rd = __ldg(&SLP_ROUNDS[r]);
        const int kind = rd.x & 255, n = (rd.x >> 8) & 255, jobs = rd.x >> 16;
        for (int k = Grp::rank(); k < jobs; k += Grp::SIZE) {
            const uint4 job = __ldg(&SLP_JOBS[rd.y + k]);
            F m;
            if (kind == SLP_MUL) {
                F x, y;
                slp_operand(x, job, 0, n, vals);
                slp_operand(y, job, 6, n, vals);
                fp_mul(m, x, y);
                slot_store(vals + slp_byte(job, 12) * F::WORDS, m);
            } else {
                fp_lincomb(m, job, n, vals);
                slot_store(vals + slp_byte(job, 14) * F::WORDS, m);
            }
        }
        Grp::sync();
    }
}

// --- slot moves and zero tests ---------------------------------------------------

// slots dst .. dst + n - 1 = src .. (src < 0: zero), a unit a slot; syncs
template <typename F, typename Grp>
BLS_INLINE void grp_copy(uint32_t *vals, int dst, int src, int n) {
    for (int k = Grp::rank(); k < n; k += Grp::SIZE) {
        F v;
        if (src < 0)
            fp_set_zero(v);
        else
            fp_load(v, vals + (src + k) * F::WORDS);
        fp_store(vals + (dst + k) * F::WORDS, v);
    }
    Grp::sync();
}

// bit k: slot s0 + k is zero (k < n). Limb: every lane tests every slot (a
// word compare); RNS: warp k tests slot s0 + k (a product and a vote) and
// the flags meet in shared memory. Syncs before returning: the group's next
// step may write what was read.
template <typename Grp>
BLS_INLINE unsigned grp_zero_mask(fp *, const uint32_t *vals, int s0, int n, int *) {
    unsigned m = 0;
    for (int k = 0; k < n; ++k) {
        fp v;
        fp_load(v, vals + (s0 + k) * 12);
        m |= (unsigned)fp_is_zero(v) << k;
    }
    Grp::sync();
    return m;
}

template <typename Grp>
BLS_INLINE unsigned grp_zero_mask(rns_w *, const uint32_t *vals, int s0, int n, int *flags) {
    for (int k = Grp::rank(); k < n; k += Grp::SIZE) {
        rns_w v;
        fp_load(v, vals + (s0 + k) * RNS_N);
        const bool z = fp_is_zero(v);
        if (rns_lane() == 0) flags[k] = z;
    }
    Grp::sync();
    unsigned m = 0;
    for (int k = 0; k < n; ++k) m |= (unsigned)(flags[k] != 0) << k;
    Grp::sync();
    return m;
}
