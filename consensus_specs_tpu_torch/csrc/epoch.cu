// K3 epoch_sweep: the registry arithmetic of one altair process_epoch, as a
// fixed launch sequence with no host sync. Replaces the XLA program built
// by consensus_specs_tpu/engine/epoch.py:85 `make_epoch_fn` -> `process_epoch`.
//
//   epoch_phase1 = epoch_reduce + epoch_sweep_a:
//     reduce  (one registry pass; u64 sums with integer atomics, exact and
//              order independent)
//     scalars (<<<1,1>>>: justification and finalization, leak, base reward
//              per increment, churn, frontier)
//     sweep A (inactivity, rewards and penalties in spec order, eject flag,
//              frontier count, activation sort key)
//   host glue:     torch.cumsum over eject (exit queue positions) and a
//                  stable torch.sort over the activation key
//   epoch_phase2 = epoch_mark + epoch_sweep_b + epoch_finalize:
//     mark    (rank < churn for every sorted position)
//     sweep B (exit and withdrawable assignment, activation, slashings,
//              effective-balance hysteresis, participation rotation, dirty
//              flags)
//     finalize (<<<1,32>>>: slashings and randao resets, aux)
//
// The registry sharded over w ranks (engine/epoch.py `make_epoch_fn(cfg,
// mesh)`, the counterpart of the JAX program under parallel/mesh.py's
// layout, where GSPMD inserts the psums) runs the same entries on each
// rank's block with collectives where the ranks must agree:
// epoch_reduce, a gather of the w scal vectors and `epoch_combine` (stage
// 0), epoch_sweep_a, a gather of scal, the eject counts and the activation
// keys and `epoch_combine` (stage 1), the exit queue from the earlier ranks'
// counts, one sort of the gathered keys, epoch_mark over the global order,
// epoch_sweep_b on the block, a gather and `epoch_combine` (stage 2), and
// epoch_finalize on the replicated vectors.
//
// Bound: device memory. Each sweep reads about 60 bytes per validator (63 MB
// a pass at N = 2^20); the arithmetic is a few dozen integer operations and
// four 64-bit divisions per validator. Everything runs in native uint64
// (wrapping exactly like the JAX program's uint64), columns are read with
// one coalesced load per field, and per-block shared-memory reductions cut
// global atomics to one per block and quantity.
//
// dirty_cols compares each final value with its pre value: sweep A writes
// its post-reward balance to a scratch column (bal_mid) and leaves
// `balances` at the pre value; sweep B holds both in registers.
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

struct EpochParams {  // field order = engine/epoch.py _params
    u64 slots_per_epoch, epochs_per_slashings_vector, epochs_per_historical_vector,
        slots_per_historical_root, max_effective_balance, ebi, base_reward_factor,
        hyst_down, hyst_up, min_epochs_to_inactivity_penalty,
        proportional_slashing_multiplier, inactivity_penalty_div, max_seed_lookahead,
        epochs_per_sync_committee_period, weight_denominator, w0, w1, w2,
        timely_head_flag_index, timely_target_flag_index, inactivity_score_bias,
        inactivity_score_recovery_rate, min_per_epoch_churn_limit, churn_limit_quotient,
        ejection_balance, min_validator_withdrawability_delay,
        epochs_per_eth1_voting_period, genesis_epoch, far;
};

// Device scalar slots (u64 scal[32]).
enum {
    S_TAB_SUM = 0,      // sum eff over active(cur)
    S_CURR_TARGET,      // sum eff over active(cur) & !slashed & curr target flag
    S_FLAG0,            // sum eff over active(prev) & !slashed & prev flag f (3 slots)
    S_ACTIVE_COUNT = S_FLAG0 + 3,
    S_MAX_EXIT,         // max exit_epoch != FAR (0 if none)
    S_SLASHINGS_SUM,
    S_FRONTIER_COUNT,   // sweep A
    S_DIRTY,            // dirty bit mask, sweeps A and B
    // written by the scalars step
    S_CUR, S_PREV, S_NXT, S_FIN, S_LEAK, S_RUN, S_TAB, S_ACTIVE_INC, S_BRPI,
    S_UP0,              // up_increments per flag (3 slots)
    S_CHURN = S_UP0 + 3, S_ACT_EXIT, S_FRONTIER, S_ADJUSTED,
    S_COUNT
};
static_assert(S_COUNT <= 32, "scalar slots");

enum { D_BAL = 0, D_EFF, D_AEE, D_ACT, D_EXIT, D_WD, D_SLASHED, D_PREV, D_CURR,
       D_INACT, D_SLASHINGS, D_RANDAO };

#define FULL 0xffffffffu

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    return v;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = umax(v, __shfl_down_sync(FULL, v, off));
    return v;
}

// Adds v into *global once per block. All threads of the block must call.
__device__ __forceinline__ void block_add(u64 v, u64* s_slot, u64* global) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(s_slot, v);
    __syncthreads();
    if (threadIdx.x == 0 && *s_slot) atomicAdd(global, *s_slot);
}

__device__ __forceinline__ void block_or(unsigned bits, unsigned* s_bits, u64* global) {
    bits = __reduce_or_sync(FULL, bits);
    if ((threadIdx.x & 31) == 0 && bits) atomicOr(s_bits, bits);
    __syncthreads();
    if (threadIdx.x == 0 && *s_bits) atomicOr(global, (u64)*s_bits);
}

__device__ __forceinline__ bool is_active(u64 act, u64 ext, u64 epoch) {
    return act <= epoch && epoch < ext;
}

__device__ __forceinline__ bool has_flag(uint8_t part, u64 idx) {
    return (part >> idx) & 1;
}

// ---------------------------------------------------------------------------
// reduce

__global__ void reduce_kernel(EpochParams P, const u64* __restrict__ slot,
                              const u64* __restrict__ eff, const u64* __restrict__ act,
                              const u64* __restrict__ ext, const bool* __restrict__ slashed,
                              const uint8_t* __restrict__ prev_part,
                              const uint8_t* __restrict__ curr_part,
                              const u64* __restrict__ slashings, u64* scal, long long n) {
    __shared__ u64 s_acc[8];
    if (threadIdx.x < 8) s_acc[threadIdx.x] = 0;
    __syncthreads();
    u64 cur = *slot / P.slots_per_epoch;
    u64 prev = cur > P.genesis_epoch ? cur - 1 : P.genesis_epoch;
    u64 tab = 0, ctgt = 0, f0 = 0, f1 = 0, f2 = 0, cnt = 0, mx = 0, sl = 0;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        u64 e = eff[i], a = act[i], x = ext[i];
        bool s = slashed[i];
        bool ac = is_active(a, x, cur), ap = is_active(a, x, prev);
        uint8_t pp = prev_part[i], cp = curr_part[i];
        if (ac) { tab += e; cnt += 1; }
        if (ac && !s && has_flag(cp, P.timely_target_flag_index)) ctgt += e;
        if (ap && !s) {
            if (pp & 1) f0 += e;
            if (pp & 2) f1 += e;
            if (pp & 4) f2 += e;
        }
        if (x != P.far) mx = umax(mx, x);
    }
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < (long long)P.epochs_per_slashings_vector; i += stride)
        sl += slashings[i];
    block_add(tab, &s_acc[0], &scal[S_TAB_SUM]);
    block_add(ctgt, &s_acc[1], &scal[S_CURR_TARGET]);
    block_add(f0, &s_acc[2], &scal[S_FLAG0]);
    block_add(f1, &s_acc[3], &scal[S_FLAG0 + 1]);
    block_add(f2, &s_acc[4], &scal[S_FLAG0 + 2]);
    block_add(cnt, &s_acc[5], &scal[S_ACTIVE_COUNT]);
    block_add(sl, &s_acc[6], &scal[S_SLASHINGS_SUM]);
    mx = warp_max(mx);
    if ((threadIdx.x & 31) == 0 && mx) atomicMax(&s_acc[7], mx);
    __syncthreads();
    if (threadIdx.x == 0 && s_acc[7]) atomicMax(&scal[S_MAX_EXIT], s_acc[7]);
}

// ---------------------------------------------------------------------------
// scalars: justification and finalization (engine/epoch.py:112-166) and the
// epoch-wide quantities of the sweeps

__device__ u64 isqrt_u64(u64 x) {
    // the JAX program's float64 sqrt with +-1 corrections (engine/epoch.py:46)
    u64 s = (u64)sqrt((double)x);
    if (s * s > x) s -= 1;
    if (s * s > x) s -= 1;
    if ((s + 1) * (s + 1) <= x) s += 1;
    return s;
}

struct Checkpoints {
    u64* prev_epoch; uint32_t* prev_root;
    u64* curr_epoch; uint32_t* curr_root;
    u64* fin_epoch; uint32_t* fin_root;
};

__global__ void scalars_kernel(EpochParams P, const u64* __restrict__ slot,
                               const uint32_t* __restrict__ block_roots, bool* bits,
                               Checkpoints C, u64* scal) {
    const u64 EBI = P.ebi;
    u64 cur = *slot / P.slots_per_epoch;
    u64 prev = cur > P.genesis_epoch ? cur - 1 : P.genesis_epoch;
    u64 tab = umax(scal[S_TAB_SUM], EBI);
    u64 fin = *C.fin_epoch;
    if (cur > P.genesis_epoch + 1) {
        u64 prev_target = umax(scal[S_FLAG0 + P.timely_target_flag_index], EBI);
        u64 curr_target = umax(scal[S_CURR_TARGET], EBI);
        u64 old_pj = *C.prev_epoch, old_cj = *C.curr_epoch;
        uint32_t old_pr[8], old_cr[8], new_r[8], fin_r[8];
        for (int k = 0; k < 8; ++k) {
            old_pr[k] = C.prev_root[k]; old_cr[k] = C.curr_root[k];
            new_r[k] = old_cr[k]; fin_r[k] = C.fin_root[k];
        }
        bool b[4] = {false, bits[0], bits[1], bits[2]};
        u64 new_j = old_cj;
        if (prev_target * 3 >= tab * 2) {
            new_j = prev;
            const uint32_t* r = block_roots + 8 * ((prev * P.slots_per_epoch) % P.slots_per_historical_root);
            for (int k = 0; k < 8; ++k) new_r[k] = r[k];
            b[1] = true;
        }
        if (curr_target * 3 >= tab * 2) {
            new_j = cur;
            const uint32_t* r = block_roots + 8 * ((cur * P.slots_per_epoch) % P.slots_per_historical_root);
            for (int k = 0; k < 8; ++k) new_r[k] = r[k];
            b[0] = true;
        }
        // finalization rules in spec order; a later hit overrides
        int pick = 0;  // 0: keep, 1: old prev justified, 2: old curr justified
        if (b[1] && b[2] && b[3] && old_pj + 3 == cur) pick = 1;
        if (b[1] && b[2] && old_pj + 2 == cur) pick = 1;
        if (b[0] && b[1] && b[2] && old_cj + 2 == cur) pick = 2;
        if (b[0] && b[1] && old_cj + 1 == cur) pick = 2;
        if (pick == 1) { fin = old_pj; for (int k = 0; k < 8; ++k) fin_r[k] = old_pr[k]; }
        if (pick == 2) { fin = old_cj; for (int k = 0; k < 8; ++k) fin_r[k] = old_cr[k]; }
        *C.prev_epoch = old_cj;
        *C.curr_epoch = new_j;
        *C.fin_epoch = fin;
        for (int k = 0; k < 8; ++k) {
            C.prev_root[k] = old_cr[k]; C.curr_root[k] = new_r[k]; C.fin_root[k] = fin_r[k];
        }
        for (int k = 0; k < 4; ++k) bits[k] = b[k];
    }
    scal[S_CUR] = cur;
    scal[S_PREV] = prev;
    scal[S_NXT] = cur + 1;
    scal[S_FIN] = fin;
    scal[S_LEAK] = (prev - fin) > P.min_epochs_to_inactivity_penalty;
    scal[S_RUN] = cur > P.genesis_epoch;
    scal[S_TAB] = tab;
    scal[S_ACTIVE_INC] = tab / EBI;
    scal[S_BRPI] = (EBI * P.base_reward_factor) / isqrt_u64(tab);
    for (int f = 0; f < 3; ++f) scal[S_UP0 + f] = umax(scal[S_FLAG0 + f], EBI) / EBI;
    scal[S_CHURN] = umax(P.min_per_epoch_churn_limit, scal[S_ACTIVE_COUNT] / P.churn_limit_quotient);
    u64 act_exit = cur + 1 + P.max_seed_lookahead;
    scal[S_ACT_EXIT] = act_exit;
    scal[S_FRONTIER] = umax(scal[S_MAX_EXIT], act_exit);
    scal[S_ADJUSTED] = umin(scal[S_SLASHINGS_SUM] * P.proportional_slashing_multiplier, tab);
}

// ---------------------------------------------------------------------------
// sweep A: inactivity (engine/epoch.py:177-195), rewards and penalties
// (:197-250), eject flag (:276-280), frontier count (:286), sort key (:301-304)

__global__ void sweep_a_kernel(EpochParams P, const u64* __restrict__ bal_in,
                               const u64* __restrict__ eff_in, const u64* __restrict__ aee_in,
                               const u64* __restrict__ act_in, const u64* __restrict__ ext_in,
                               const u64* __restrict__ wd_in, const bool* __restrict__ slashed,
                               const uint8_t* __restrict__ prev_part, u64* inact,
                               u64* scal, u64* __restrict__ bal_mid,
                               uint8_t* __restrict__ eject_out, long long* __restrict__ key_out,
                               long long n) {
    __shared__ u64 s_cnt;
    __shared__ unsigned s_bits;
    if (threadIdx.x == 0) { s_cnt = 0; s_bits = 0; }
    __syncthreads();
    const u64 cur = scal[S_CUR], prev = scal[S_PREV], fin = scal[S_FIN];
    const bool leak = scal[S_LEAK], run = scal[S_RUN];
    const u64 ai_wd = scal[S_ACTIVE_INC] * P.weight_denominator;
    const u64 brpi = scal[S_BRPI], frontier = scal[S_FRONTIER];
    const u64 up[3] = {scal[S_UP0], scal[S_UP0 + 1], scal[S_UP0 + 2]};
    const u64 w[3] = {P.w0, P.w1, P.w2};
    const u64 EBI = P.ebi, FAR = P.far;
    u64 fcount = 0;
    unsigned dirty = 0;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        u64 e = eff_in[i], a = act_in[i], x = ext_in[i], aee = aee_in[i];
        bool s = slashed[i];
        uint8_t pp = prev_part[i];
        bool ac = is_active(a, x, cur), ap = is_active(a, x, prev);
        u64 bal = bal_in[i];
        if (run) {
            bool eligible = ap || (s && prev + 1 < wd_in[i]);
            bool target = ap && !s && has_flag(pp, P.timely_target_flag_index);
            u64 score0 = inact[i], score = score0;
            if (eligible && target) score -= umin(1, score);
            if (eligible && !target) score += P.inactivity_score_bias;
            if (eligible && !leak) score -= umin(P.inactivity_score_recovery_rate, score);
            if (score != score0) { inact[i] = score; dirty |= 1u << D_INACT; }

            u64 base_reward = (e / EBI) * brpi;
#pragma unroll
            for (int f = 0; f < 3; ++f) {
                bool part = ap && !s && has_flag(pp, f);
                u64 reward = (eligible && part && !leak) ? base_reward * w[f] * up[f] / ai_wd : 0;
                u64 penalty = ((u64)f != P.timely_head_flag_index && eligible && !part)
                                  ? base_reward * w[f] / P.weight_denominator : 0;
                bal += reward;
                bal -= umin(penalty, bal);
            }
            u64 ipen = (eligible && !target) ? e * score / P.inactivity_penalty_div : 0;
            bal -= umin(ipen, bal);
        }
        bal_mid[i] = bal;
        eject_out[i] = ac && e <= P.ejection_balance && x == FAR;
        if (x == frontier) fcount += 1;
        u64 new_aee = (aee == FAR && e == P.max_effective_balance) ? cur + 1 : aee;
        bool elig_act = new_aee <= fin && a == FAR;
        // unsigned order as signed order: flip the sign bit (FAR sorts last)
        key_out[i] = (long long)((elig_act ? new_aee : FAR) ^ 0x8000000000000000ull);
    }
    block_add(fcount, &s_cnt, &scal[S_FRONTIER_COUNT]);
    block_or(dirty, &s_bits, &scal[S_DIRTY]);
}

// ---------------------------------------------------------------------------
// mark: rank_ok[order[j]] = j < churn (engine/epoch.py:305-307)

__global__ void mark_kernel(const long long* __restrict__ order, const u64* scal,
                            uint8_t* __restrict__ rank_ok, long long n) {
    const u64 churn = scal[S_CHURN];
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride)
        rank_ok[order[j]] = (u64)j < churn;
}

// ---------------------------------------------------------------------------
// sweep B: exits (:287-297), activations (:301-308), slashings (:318-330),
// effective balances (:332-340), participation rotation (:367-371)

__global__ void sweep_b_kernel(EpochParams P, u64* bal_io, u64* eff_io, u64* aee_io,
                               u64* act_io, u64* ext_io, u64* wd_io,
                               const bool* __restrict__ slashed, uint8_t* prev_part,
                               uint8_t* curr_part, u64* scal, const u64* __restrict__ bal_mid,
                               const uint8_t* __restrict__ eject,
                               const long long* __restrict__ cums,
                               const uint8_t* __restrict__ rank_ok, long long n) {
    __shared__ unsigned s_bits;
    if (threadIdx.x == 0) s_bits = 0;
    __syncthreads();
    const u64 cur = scal[S_CUR], fin = scal[S_FIN], churn = scal[S_CHURN];
    const u64 act_exit = scal[S_ACT_EXIT], frontier = scal[S_FRONTIER];
    const u64 fc = scal[S_FRONTIER_COUNT];
    const u64 avail0 = churn > fc ? churn - fc : 0;
    const u64 tab = scal[S_TAB], adjusted = scal[S_ADJUSTED];
    const u64 EBI = P.ebi, FAR = P.far;
    const u64 hit_epoch = cur + P.epochs_per_slashings_vector / 2;
    unsigned dirty = 0;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        u64 bal0 = bal_io[i], e0 = eff_io[i], aee0 = aee_io[i], a0 = act_io[i];
        u64 x0 = ext_io[i], wd0 = wd_io[i];
        bool s = slashed[i];
        uint8_t pp0 = prev_part[i], cp0 = curr_part[i];
        u64 bal = bal_mid[i];

        u64 aee = (aee0 == FAR && e0 == P.max_effective_balance) ? cur + 1 : aee0;
        u64 x = x0, wd = wd0;
        if (eject[i]) {
            u64 qpos = (u64)cums[i] - 1;
            u64 assigned = qpos < avail0 ? frontier : frontier + 1 + (qpos - avail0) / churn;
            x = assigned;
            wd = assigned + P.min_validator_withdrawability_delay;
        }
        bool elig_act = aee <= fin && a0 == FAR;
        u64 a = (elig_act && rank_ok[i]) ? act_exit : a0;

        if (s && hit_epoch == wd) {
            u64 penalty = e0 / EBI * adjusted / tab * EBI;
            bal -= umin(penalty, bal);
        }
        u64 e = e0;
        if (bal + P.hyst_down < e0 || e0 + P.hyst_up < bal)
            e = umin(bal - bal % EBI, P.max_effective_balance);

        if (bal != bal0) { bal_io[i] = bal; dirty |= 1u << D_BAL; }
        if (e != e0) { eff_io[i] = e; dirty |= 1u << D_EFF; }
        if (aee != aee0) { aee_io[i] = aee; dirty |= 1u << D_AEE; }
        if (a != a0) { act_io[i] = a; dirty |= 1u << D_ACT; }
        if (x != x0) { ext_io[i] = x; dirty |= 1u << D_EXIT; }
        if (wd != wd0) { wd_io[i] = wd; dirty |= 1u << D_WD; }
        prev_part[i] = cp0;
        curr_part[i] = 0;
        if (pp0 != cp0) dirty |= 1u << D_PREV;
        if (cp0 != 0) dirty |= 1u << D_CURR;
    }
    block_or(dirty, &s_bits, &scal[S_DIRTY]);
}

// ---------------------------------------------------------------------------
// finalize: slashings reset (:355-359), randao mixes reset (:361-366), aux
// flags and dirty_cols (:377-389). One warp.

__global__ void finalize_kernel(EpochParams P, u64* slashings, uint32_t* mixes, u64* scal,
                                bool* aux) {
    const u64 cur = scal[S_CUR], nxt = scal[S_NXT];
    __shared__ unsigned s_extra;
    if (threadIdx.x == 0) {
        unsigned extra = 0;
        u64* row = &slashings[nxt % P.epochs_per_slashings_vector];
        if (*row != 0) { *row = 0; extra |= 1u << D_SLASHINGS; }
        s_extra = extra;
    }
    __syncwarp();
    // randao row copy, one lane per word
    if (threadIdx.x < 8) {
        u64 ephv = P.epochs_per_historical_vector;
        uint32_t v = mixes[8 * (cur % ephv) + threadIdx.x];
        uint32_t* dst = &mixes[8 * (nxt % ephv) + threadIdx.x];
        bool diff = *dst != v;
        *dst = v;
        if (__any_sync(0xffu, diff) && threadIdx.x == 0) s_extra |= 1u << D_RANDAO;
    }
    __syncwarp();
    if (threadIdx.x == 0) {
        u64 dirty = scal[S_DIRTY] | s_extra;
        u64 per_batch = P.slots_per_historical_root / P.slots_per_epoch;
        aux[0] = nxt % per_batch == 0;
        aux[1] = nxt % P.epochs_per_eth1_voting_period == 0;
        aux[2] = nxt % P.epochs_per_sync_committee_period == 0;
        for (int k = 0; k < 12; ++k) aux[3 + k] = (dirty >> k) & 1;
    }
}

// ---------------------------------------------------------------------------
// combine: fold the w ranks' scal vectors (parts, w x 32) into scal, a thread
// a slot. Stage 0 (after reduce): the balance sums, the active count and the
// frontier count add, the largest exit is a max, the dirty mask an OR, and
// the slashings sum is rank 0's (every rank sums the whole replicated
// vector). Stage 1 (after sweep A): the frontier counts add and the dirty
// masks OR. Stage 2 (after sweep B): the dirty masks OR. Every other slot is
// rank 0's: the ranks computed it from the same combined values.

__global__ void combine_kernel(const u64* __restrict__ parts, u64* scal, long long w,
                               int stage) {
    const int k = threadIdx.x;
    u64 v = parts[k];
    for (long long r = 1; r < w; ++r) {
        u64 x = parts[32 * r + k];
        if (k == S_DIRTY) v |= x;
        else if (k == S_FRONTIER_COUNT && stage <= 1) v += x;
        else if (stage == 0 && k <= S_ACTIVE_COUNT) v += x;
        else if (stage == 0 && k == S_MAX_EXIT) v = umax(v, x);
    }
    scal[k] = v;
}

// ---------------------------------------------------------------------------
// C entry points

static unsigned grid_for(long long n, int threads) {
    long long b = (n + threads - 1) / threads;
    if (b > 4096) b = 4096;  // grid-stride beyond this
    return (unsigned)(b < 1 ? 1 : b);
}

extern "C" int epoch_params_count() { return (int)(sizeof(EpochParams) / sizeof(u64)); }

static int reduce_launch(const EpochParams& P, const void* slot, const void* eff,
                         const void* act, const void* ext, const void* slashed,
                         const void* prev_part, const void* curr_part, const void* slashings,
                         void* scal, long long n, cudaStream_t st) {
    const int T = 256;
    unsigned g = grid_for(n > (long long)P.epochs_per_slashings_vector
                              ? n : (long long)P.epochs_per_slashings_vector, T);
    cudaMemsetAsync(scal, 0, 32 * sizeof(u64), st);
    reduce_kernel<<<g, T, 0, st>>>(P, (const u64*)slot, (const u64*)eff, (const u64*)act,
                                   (const u64*)ext, (const bool*)slashed,
                                   (const uint8_t*)prev_part, (const uint8_t*)curr_part,
                                   (const u64*)slashings, (u64*)scal, n);
    return (int)cudaGetLastError();
}

static int sweep_a_launch(const EpochParams& P, const void* slot, const void* bal,
                          const void* eff, const void* aee, const void* act, const void* ext,
                          const void* wd, const void* slashed, const void* prev_part,
                          void* inact, const void* block_roots, void* just_bits,
                          const void* ckpts, void* scal, void* bal_mid, void* eject, void* key,
                          long long n, cudaStream_t st) {
    void* const* c = (void* const*)ckpts;
    Checkpoints C = {(u64*)c[0], (uint32_t*)c[1], (u64*)c[2], (uint32_t*)c[3],
                     (u64*)c[4], (uint32_t*)c[5]};
    const int T = 256;
    scalars_kernel<<<1, 1, 0, st>>>(P, (const u64*)slot, (const uint32_t*)block_roots,
                                    (bool*)just_bits, C, (u64*)scal);
    sweep_a_kernel<<<grid_for(n, T), T, 0, st>>>(
        P, (const u64*)bal, (const u64*)eff, (const u64*)aee, (const u64*)act,
        (const u64*)ext, (const u64*)wd, (const bool*)slashed, (const uint8_t*)prev_part,
        (u64*)inact, (u64*)scal, (u64*)bal_mid, (uint8_t*)eject, (long long*)key, n);
    return (int)cudaGetLastError();
}

static int mark_launch(const void* order, const void* scal, void* rank_ok, long long n,
                       cudaStream_t st) {
    mark_kernel<<<grid_for(n, 256), 256, 0, st>>>((const long long*)order, (const u64*)scal,
                                                 (uint8_t*)rank_ok, n);
    return (int)cudaGetLastError();
}

static int sweep_b_launch(const EpochParams& P, void* bal, void* eff, void* aee, void* act,
                          void* ext, void* wd, const void* slashed, void* prev_part,
                          void* curr_part, void* scal, const void* bal_mid, const void* eject,
                          const void* cums, const void* rank_ok, long long n, cudaStream_t st) {
    sweep_b_kernel<<<grid_for(n, 256), 256, 0, st>>>(
        P, (u64*)bal, (u64*)eff, (u64*)aee, (u64*)act, (u64*)ext, (u64*)wd,
        (const bool*)slashed, (uint8_t*)prev_part, (uint8_t*)curr_part, (u64*)scal,
        (const u64*)bal_mid, (const uint8_t*)eject, (const long long*)cums,
        (const uint8_t*)rank_ok, n);
    return (int)cudaGetLastError();
}

static int finalize_launch(const EpochParams& P, void* slashings, void* mixes, void* scal,
                           void* aux, cudaStream_t st) {
    finalize_kernel<<<1, 32, 0, st>>>(P, (u64*)slashings, (uint32_t*)mixes, (u64*)scal,
                                      (bool*)aux);
    return (int)cudaGetLastError();
}

// reduce alone: scal's sums over this block of the registry
extern "C" int epoch_reduce(const void* params, const void* slot, const void* eff,
                            const void* act, const void* ext, const void* slashed,
                            const void* prev_part, const void* curr_part,
                            const void* slashings, void* scal, long long n, void* stream) {
    return reduce_launch(*(const EpochParams*)params, slot, eff, act, ext, slashed, prev_part,
                         curr_part, slashings, scal, n, (cudaStream_t)stream);
}

// scalars + sweep A over the (combined) sums in scal
extern "C" int epoch_sweep_a(const void* params, const void* slot, const void* bal,
                             const void* eff, const void* aee, const void* act,
                             const void* ext, const void* wd, const void* slashed,
                             const void* prev_part, void* inact, const void* block_roots,
                             void* just_bits, const void* ckpts, void* scal, void* bal_mid,
                             void* eject, void* key, long long n, void* stream) {
    return sweep_a_launch(*(const EpochParams*)params, slot, bal, eff, aee, act, ext, wd,
                          slashed, prev_part, inact, block_roots, just_bits, ckpts, scal,
                          bal_mid, eject, key, n, (cudaStream_t)stream);
}

extern "C" int epoch_phase1(const void* params, const void* slot, const void* bal,
                            const void* eff, const void* aee, const void* act, const void* ext,
                            const void* wd, const void* slashed, const void* prev_part,
                            const void* curr_part, void* inact, const void* slashings,
                            const void* block_roots, void* just_bits, const void* ckpts,
                            void* scal, void* bal_mid, void* eject, void* key, long long n,
                            void* stream) {
    const EpochParams P = *(const EpochParams*)params;
    cudaStream_t st = (cudaStream_t)stream;
    int e = reduce_launch(P, slot, eff, act, ext, slashed, prev_part, curr_part, slashings,
                          scal, n, st);
    if (e) return e;
    return sweep_a_launch(P, slot, bal, eff, aee, act, ext, wd, slashed, prev_part, inact,
                          block_roots, just_bits, ckpts, scal, bal_mid, eject, key, n, st);
}

// scal <- the fold of the w vectors in parts (w x 32 u64) at `stage`
extern "C" int epoch_combine(const void* parts, void* scal, long long w, long long stage,
                             void* stream) {
    if (w < 1) return (int)cudaErrorInvalidValue;
    combine_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const u64*)parts, (u64*)scal, w,
                                                       (int)stage);
    return (int)cudaGetLastError();
}

// mark alone, over an order of n positions (the whole registry's when sharded)
extern "C" int epoch_mark(const void* order, const void* scal, void* rank_ok, long long n,
                          void* stream) {
    return mark_launch(order, scal, rank_ok, n, (cudaStream_t)stream);
}

extern "C" int epoch_sweep_b(const void* params, void* bal, void* eff, void* aee, void* act,
                             void* ext, void* wd, const void* slashed, void* prev_part,
                             void* curr_part, void* scal, const void* bal_mid,
                             const void* eject, const void* cums, const void* rank_ok,
                             long long n, void* stream) {
    return sweep_b_launch(*(const EpochParams*)params, bal, eff, aee, act, ext, wd, slashed,
                          prev_part, curr_part, scal, bal_mid, eject, cums, rank_ok, n,
                          (cudaStream_t)stream);
}

extern "C" int epoch_finalize(const void* params, void* slashings, void* mixes, void* scal,
                              void* aux, long long n, void* stream) {
    return finalize_launch(*(const EpochParams*)params, slashings, mixes, scal, aux,
                           (cudaStream_t)stream);
}

extern "C" int epoch_phase2(const void* params, void* bal, void* eff, void* aee, void* act,
                            void* ext, void* wd, const void* slashed, void* prev_part,
                            void* curr_part, void* slashings, void* mixes, void* scal,
                            const void* bal_mid, const void* eject, const void* cums,
                            const void* order, void* rank_ok, void* aux, long long n,
                            void* stream) {
    const EpochParams P = *(const EpochParams*)params;
    cudaStream_t st = (cudaStream_t)stream;
    int e = mark_launch(order, scal, rank_ok, n, st);
    if (!e) e = sweep_b_launch(P, bal, eff, aee, act, ext, wd, slashed, prev_part, curr_part,
                               scal, bal_mid, eject, cums, rank_ok, n, st);
    if (!e) e = finalize_launch(P, slashings, mixes, scal, aux, st);
    return e;
}
