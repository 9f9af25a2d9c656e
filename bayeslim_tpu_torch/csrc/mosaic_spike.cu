// The seven contraction and phasor-rotation microbenchmarks of
// scripts/mosaic_spike.py as kernels for NVIDIA Hopper (sm_90a).
//
// Each kernel computes the function of the TPU kernel of the same name
// (k_nn :46, k_nt :65, k_vt :84, k_lr :100, k_bd :119, k_rot :147,
// k_fwd :180), not its TPU block layout: the block-diagonal MXU product
// of k_bd / k_fwd and the VMEM scratch have no counterpart here. All
// arrays are float32, row-major and contiguous; sizes follow the script:
// ps (NF, TC), ct (NF, TB), m and tau (TC, TB).
//
//   k_nn   out[j, b] = sum_c ps[j, c] m[c, b]                      (NF, TB)
//   k_nt   out[j, c] = sum_b ct[j, b] m[c, b]                      (NF, TC)
//   k_vt   out[c, b] = m[c, b] sum_j ps[j, c]                      (TC, TB)
//   k_lr   as k_nt, the sum over b split over lanes and shuffled
//   k_bd   out[j, b] = (1 + j mod G) sum_c ps[j, c] m[c, b]       (NF, TB)
//   k_rot  (c, s) <- (c cd - s sd, s cd + c sd) NF times from (m, m/2),
//          cd = 0.9 m, sd = 0.1 m; out = c + s                     (TC, TB)
//   k_fwd  out_re/im[k, b] = sum_c ps[k, c] cos/sin(k tau[c, b])   (NF, TB)
//
// What bounds their functions on this card (FP32 at 67 TFLOP/s, bytes
// at 3.35 TB/s): the products k_nn, k_nt, k_lr and k_bd are operations
// (2 NF TC TB FLOP on ~1.6 MB); k_fwd is operations too, the
// contraction's two FMAs per (k, c, b). k_vt needs only a column sum
// and one product, and k_rot's result only ~11 complex products by
// repeated squaring, so both are bytes. k_rot computes its closed form,
// a float-float power in O(log NF) operations an element, not the TPU
// body's NF rotations; k_fwd keeps its phasor recurrence, in chains of
// one FMA a component and row beside the sum's two; k_vt does its
// function's column sum. Every kernel uses plain FP32 arithmetic: no
// TF32, no tensor cores, no FP64.
//
// k_nn, k_nt and k_bd share a ring-buffered SGEMM, k_lr has a
// register-tiled product with its b axis split over lanes, k_vt a
// cluster-wide column sum, k_fwd rime_fwd.cu's runs and chains and
// k_rot an elementwise power (designs below), all redesigned for the
// card.
//
// ---- The SGEMM of k_nn and k_nt (sgemm_ring). C (M, N) = A (M, K) B,
// B stored (K, N) for k_nn and (N, K) for k_nt (C = A B^T). At the
// spike's shape (M = 1024, N = K = 256) the bound is 2 M N K FLOP at
// the FP32 rate, 2.0 us; the first tile (64 x 64, 8 warps a block,
// scalar staging that waited for each 16-deep slice) ran 12-14x that.
// What the design does:
//
// - Fill the card: 64 x 32 output tiles, so 16 x 8 = 128 blocks on the
//   132 SMs at the spike's shape (the 64 x 64 tile gave 64 blocks, half
//   the card idle). 128 threads a block; each owns 4 rows x 4 columns
//   in registers, rows ty + 16 i (ty = tid / 8) and columns tx + 8 j
//   (k_nt) or 4 tx + j (k_nn), tx = tid % 8.
// - Copy without registers: cp.async in 16-byte chunks straight into
//   shared memory, no transposes. A lands as [m][k]; B as [n][k] for
//   k_nt and as [k][n] for k_nn, each row padded by 4 words. The inner
//   loop takes 4 k at a time: per row of A one LDS.128 of 4 k; per
//   column of B (k_nt) one LDS.128 of 4 k, or per k (k_nn) one LDS.128
//   of 4 columns: 8 LDS.128 for 64 FFMA. A warp's lanes read 4 rows of
//   A (offsets 4 words apart in the banks: no conflict, the 8 lanes of
//   a row broadcast) and 8 columns of B (4 words apart, or 128
//   contiguous bytes for k_nn).
// - Keep the loads in flight: a ring of SG_STAGES = 2 slots of SG_BK =
//   64 k (26 KB each, 51-52 KB of dynamic shared memory). The first
//   slice is issued before the loop, each slice its own commit group;
//   the loop waits for slice kt (cp.async.wait_group), passes one
//   barrier, issues slice kt + SG_STAGES - 1 into the slot that slice
//   kt - 1 used (every thread has left it at that barrier) and computes
//   slice kt, so the next slice loads while this one computes. Two
//   slots, not four: with four, slices 0-2 were issued together and
//   shared the memory system, so the first one, which the loop waits
//   for, landed later; two slots ran in 0.89-0.93x the time of four
//   (bayeslim_tpu_torch/scripts/sgemm_variants.py on the card).
// - Ragged edges: rows and columns past M or N and k past K are
//   zero-filled by cp.async's src-size operand (nothing is read) and the
//   stores are masked. When K (k_nn: or N) is not a multiple of 4, or A
//   or B is not 16-byte aligned, the launcher picks the same kernel
//   with 4-byte chunks (template CH). The wrapper's sgemm_plan
//   (bayeslim_tpu_torch/scripts/mosaic_spike.py) mirrors the launcher's
//   choice, grid and shared memory; the C sgemm_plan below gives the
//   launcher's own, for the card's check of the two.
// - Fixed order: each output is one thread's chain of fmaf over k = 0,
//   1, ..., K - 1 (the zero-filled k add exact zeros), so two launches
//   are bit-equal. FFMA only: no TF32, no tensor cores, no FP64.
//
// What still bounds it at the spike's shape (sgemm_variants.py on the
// card; PERF.md): the copies, barriers and stores alone take ~70 % of
// the kernel's time and the inner loop alone ~80 %, so neither hides
// behind the other. If an LDS.128 takes one shared-memory wavefront a
// quarter warp (counted, not measured), the loop needs 32 wavefronts a
// warp per 64 FFMA, twice its FFMA time. Larger thread tiles halve that
// but leave fewer warps than schedulers, or fewer blocks than SMs, at
// this shape; k_lr's split of the k axis over lanes (below) keeps 8 x 8
// outputs a lane on 256 blocks and runs in 0.88-0.89x k_nt's time.
//
// ---- k_lr: C (NF, TC) = ct (NF, TB) m (TC, TB)^T with the TPU body's
// reduction over b across lanes kept, as a K split inside the warp.
// Bound by operations: 2.0 us at the spike's shape. What the design
// does:
//
// - 32 x 32 output tiles of 128 threads: 256 blocks at the spike's
//   shape, two an SM (40 KB of shared memory, 212 registers a thread).
//   ct and m land by cp.async (sg_stage) as [j][b] and [c][b] in a ring
//   of LR_STAGES = 2 slots of LR_BK = 64 b, with the SGEMM's chunk rule
//   (CH) and zero-fill.
// - Each output belongs to LR_S = 8 neighbouring lanes; lane q of the
//   eight takes the float4s of b at 4 q, 4 q + 32, ... and owns 8 rows
//   (ry + 4 i) x 8 columns (cx + 4 j) = 64 partial sums. Per 4 b a lane
//   issues 16 LDS.128 for 256 FFMA (the SGEMM: 8 for 64). A quarter
//   warp is one group of eight reading 128 contiguous bytes of a row, so
//   no LDS.128 has a bank conflict (the row stride of LR_BK + 16 words
//   keeps a split of 4 conflict-free too).
// - At the end, a reduce-scatter over the eight lanes (xor 1, 2, 4):
//   each step sends half of what a lane holds, 56 SHFL a lane in all
//   against 2,048 FFMA at TB = 256; each lane then stores 8 outputs.
// - Fixed order: each lane's partials are one fmaf chain in b order,
//   and the lanes add as ((q0 + q1) + (q2 + q3)) + ((q4 + q5) + (q6 +
//   q7)), so two launches are bit-equal. FFMA only: no TF32, no tensor
//   cores, no FP64.
//
// Measured against the alternatives (scripts/vt_lr_variants.py on the
// card; PERF.md): a split of 4 with 64 x 32 tiles (128 blocks, one an
// SM) ran 1.26x this time, splits of 2 and 16 1.37-2.33x, 4 x 8 outputs
// a lane 1.04-1.15x, three slots 1.06x. The copies, barriers and stores
// alone take ~70 % of the time (the 256 blocks read 16 MB of tiles from
// L2) and the launch ~17 %: a cluster sharing its tiles through
// distributed shared memory is the next lever.
//
// ---- k_vt: out[c, b] = m[c, b] s[c], s = the column sum of ps, bound
// by bytes (ps read once, m read and out written once: 1.5 MB, 0.47 us
// at the spike's shape). The TPU body's NF FMAs per output are not
// needed: the first kernel walked a column of ps per output serially.
// One launch on thread-block clusters:
//
// - A cluster of VT_CL = 4 blocks owns VT_GC = 16 columns c (16 x 4 =
//   64 blocks at the spike's shape). Block rank r sums rows j of its
//   quarter of NF: threads read float4s along c, neighbouring threads on
//   neighbouring addresses, each down its column(s) in j order; the
//   lanes of a column add by xor shuffles and the warps in order through
//   shared memory.
// - After cluster.sync(), each block reads the VT_CL partial sums of its
//   VT_GC / VT_CL rows of out from every rank's shared memory
//   (distributed shared memory, map_shared_rank) in rank order, arrives
//   on the cluster barrier, and writes its rows out[c, :] = s[c] m[c, :]
//   along b. It waits on the barrier before it exits, so no block leaves
//   while another still reads its shared memory.
// - Every sum has one fixed order: launches are bit-equal. Ragged or
//   unaligned rows take 4-byte loads (template CH), as the SGEMM does.
//
// Measured (vt_lr_variants.py): clusters of 8 (128 blocks) ran 1.05x
// this time, of 16 1.12x, of 2 1.22x, one block a group with no cluster
// 1.55x, 8 or 32 columns a group 1.07-1.18x. The launch alone takes a
// third of the time; without the column sum, or without the product,
// the kernel runs in ~0.9x: the rest is the phases' latency, one after
// another, not bytes.
//
// ---- k_bd: out (NF, TB) = diag(1 + j mod G) ps (NF, TC) m (TC, TB),
// bound by operations (2.0 us at the spike's shape). It is k_nn's
// product: sgemm_ring<false, CH, true> (128 blocks, the cp.async ring,
// the chunk rule, zero-fill, one fixed k order an output) with the row
// scale applied in the epilogue, once an output as it is stored. Its
// launch is k_nn's (sgemm_plan_of with nt = 0). The first tile (64 x 64,
// 64 blocks, scalar staging that waited for every 16-deep slice) ran
// 0.0233 ms. The other candidate, k_lr's lane split adapted to m stored
// [c][b] (its rows' 16-byte chunks XOR-swizzled so that a quarter warp
// reads 8 rows without a conflict), ran 1.16-1.18x this kernel's time
// (scripts/bd_fwd_variants.py on the card).
//
// ---- k_fwd: (re, im)[k, b] = sum_c ps[k, c] (cos, sin)(k tau[c, b]),
// tau in radians. Bound by operations: the contraction's two FMAs a
// triple (4.0 us at the spike's shape, 0.237 ms at hera-stat's forward
// shape). The first kernel took three accurate sincosf a (c, b) in each
// of its 8 row groups, 31 rotations (4 operations each) against 64 FMAs,
// and added its c slices with atomics into outputs zeroed by two more
// launches. rime_fwd.cu's design, carried over to radians:
//
// - A table of steps a tile: for every (c, b) of a 32-wide c tile the
//   block computes D = e^{i t} and D^CH = e^{i CH t} once (fw_sincos: a
//   three-part reduction by pi/2 and minimax polynomials, a few ulp, no
//   FP64; CH t is exact), in shared memory for its 8 runs.
// - Runs: a thread owns one column b and FW_RT = 32 consecutive rows
//   k0 .. k0 + 31, its 64 sums in registers, and seeds e^{i k0 t} once
//   a (c, b): k0 t = x + xe exactly (xe by fmaf), x - q 2 pi by a
//   three-part Cody-Waite split of 2 pi (the first part exact with q),
//   xe added, then the SFU's __sincosf on [-pi, pi]. k0 t reaches ~5,000
//   rad at the spike's N(0, 1) tau; the SFU is accurate only after the
//   reduction (2^-21.41 absolute there), which is exact in its first
//   step for |k t| < 4e5.
// - Chains: rows 1 .. CH - 1 from the seed by D, D^2, D^4 (at most log2
//   CH + 1 products deep), rows CH .. 2 CH - 1 by D^CH, then CH = 4
//   chains over rows g + 4 j advanced by the two-term recurrence e_{j+1}
//   = 2 Re(D^4) e_j - e_{j-1}, one FMA a component and row; no chain
//   takes more than 6 steps. About 5 FP32 instructions a triple, 2 of
//   them the sum's. The plain version's G chains are its own: the
//   kernel's sum is the same function at every G.
// - Staging: ps lands transposed ([c][row], a warp reads its rows as
//   float4 broadcasts) and tau along b by 4-byte cp.async (no staging
//   registers, zero-fill past NF, TB and the slice) into two slots, so
//   the next tile loads while this one computes.
// - Slices without atomics: c is split into S <= 8 slices (fwd_plan_of:
//   the S that fills whole waves of two blocks an SM), one block each,
//   that store their partial sums to a scratch (S, 2, NF, TB) from
//   torch.empty; fw_sum adds the slices in a fixed order, as
//   rime_fwd_sum does (S = 1 stores the outputs directly). No memset, no
//   atomics: two launches are bit-equal. FFMA only.
//
// Measured (scripts/bd_fwd_variants.py on the card; PERF.md): the S
// blocks of a tile as a thread-block cluster that adds the slices
// through distributed shared memory in one launch ran 1.47-1.54x this
// time (fewer blocks were resident); one slice 1.66-3.1x, 2 slices
// 1.49-1.70x, 4 slices 1.00-1.15x; 2 or 8 chains and 16-row runs within
// 3 %; seeds by fw_sincos instead of the SFU 1.04x. At the spike's shape
// a block has one c tile, and its fixed phases (staging, table, the
// 16 MB of partials and their sum) take about half the time: the seeds
// and table alone ran 0.54x, the launch and the sum kernel alone 0.18x.
//
// ---- k_rot: out = c_NF + s_NF of the TPU body's recurrence (c, s) <-
// (c cd - s sd, s cd + c sd) from (m, m/2), cd = 0.9 m, sd = 0.1 m.
// Each step multiplies z = c + i s by w = m (0.9 + 0.1 i), so with rho
// = sqrt(0.82) and theta = atan2(0.1, 0.9)
//
//   out = Re + Im of m (1 + i/2) w^NF = A_NF m (rho m)^NF,
//   A_NF = 1.5 cos(NF theta) + 0.5 sin(NF theta),
//
// A_NF one constant a call. Bound by bytes (m read once, out written
// once: 8 bytes an element). The first kernel ran the TPU body's NF
// dependent rotations (6 FLOP a step) per element: O(NF) work for a
// function that needs O(log NF), and its float32 error grew with NF
// (4.8e-5 relative at NF = 1024, 2.2e-4 at 4096: the rounding of cd,
// sd and w, which NF multiplies in any order of the steps, so a plain
// float32 power of w is no better). What the design does:
//
// - The host computes A_NF and rho in float64 and passes each as a
//   float32 pair hi + lo (scripts/mosaic_spike.py::rot_consts).
// - x = rho m as a float pair (FF: h + l, ~48 bits), then x^NF by
//   right-to-left binary powering in float-float: bit_length(NF) - 1
//   squarings of x and popcount(NF) products into r, which starts at
//   A_NF m, so the last product is the result. 5 FP32 instructions a
//   squaring or product (ff_sqr, ff_mul), 3 for the last (only its
//   rounded h is kept): ~60 an element at NF = 1024. rho stays inside
//   the base, so (rho m)^k stays near 1 wherever the result is finite;
//   m^(NF+1) or rho^NF alone would leave float32's range (1.6e44 and
//   7e-45 at NF = 1024). NF is the same for every thread, so the loop
//   over its bits never diverges; it is unrolled by 4, which lets the
//   compiler rename the pairs' registers instead of copying them back.
// - Accuracy: each product keeps h + l within ~2^-45 of its exact
//   value, so the power is within ~NF 2^-45 of (rho m)^NF (the pair
//   rho adds NF 2^-48), and the result within its final float32
//   rounding (~6e-8) for NF up to ~2^16 (the CPU model: <= 5.1e-8 at
//   NF <= 16384), within 1e-6 up to NF ~ 2^25. Explicit __fmul_rn /
//   __fmaf_rn / __fadd_rn: nvcc contracts nothing, and the numpy model
//   in tests/test_torch_mosaic_spike.py follows them bit for bit.
// - Memory: a thread takes 4 elements by one 16-byte load and
//   store (their 4 powers interleave as independent chains), in a
//   grid-stride loop over one wave of resident blocks that issues each
//   group's load before the previous group's power; when m or out
//   is not 16-byte aligned the launcher takes the same kernel with one
//   element a thread, and a ragged n leaves a scalar tail to the first
//   block. No early exit: where the power overflows or underflows
//   (mk's N(0, 1) inputs) the output is inf, NaN or 0, as the loop's
//   is, in the same time.
// - Fixed order: two launches are bit-equal, and the vector and scalar
//   paths give an element the same bits.
//
// Measured (scripts/rot_variants.py on the card; PERF.md), NF = 1024 at
// hera-stat's forward shape (6144 x 630), L2 warm / emptied before each
// launch: 0.0120 / 0.0192 ms against the first design's 0.663 / 0.668
// ms. A complex float-float power of w ran 4.3 / 3.0x this time; a
// plain float32 power 1.06 / 1.02x, at 6.7e-5 / 9.9e-4 relative error
// (NF = 1024 / 16384); one element a thread 2.0 / 1.7x, 8 elements
// 1.02 / 1.01x, one group a thread 1.09 / 1.05x, no prefetch 1.03 /
// 1.00x; the bit loop not unrolled 1.12 / 1.07x (its SASS copied the
// pairs back with 4 MOVs an iteration), by 2 or 8 1.04-1.06 / 0.99-1.00x.
// The loads and stores alone took 0.50 / 0.80x and the launch alone
// 0.12 / 0.10x: with L2 warm the power's instructions bound the kernel,
// with L2 emptied mostly the memory path (31 MB at ~2.3 TB/s there).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool aligned16(const void* p)
{
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// cp.async of CH (16 or 4) bytes from global src to shared dst; zeros
// when `in` is false (src-size 0: nothing is read)
template <int CH>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (CH == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(in ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's commit groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// ---- k_nn, k_nt: the ring-buffered SGEMM (design in the header)
constexpr int SG_BM = 64, SG_BN = 32, SG_BK = 64, SG_STAGES = 2;
// 4 x 4 outputs a thread: SG_TX threads across the columns, SG_TY down
constexpr int SG_TX = SG_BN / 4, SG_TY = SG_BM / 4, SG_T = SG_TX * SG_TY;
constexpr int SG_LDK = SG_BK + 4;      // words a row of A, or of B for k_nt
constexpr int SG_LDN = SG_BN + 4;      // words a k-row of B for k_nn

__host__ __device__ constexpr int sg_stage_words(bool nt)
{
    return SG_BM * SG_LDK + (nt ? SG_BN * SG_LDK : SG_BK * SG_LDN);
}

// A slice of k: rows x SG_BK (stride K) or SG_BK x cols (stride N) of a
// row-major operand, staged as CH-byte chunks along its contiguous axis
// into dst (row stride ld); chunks past (rows_in, cols_in) are zeros
template <int CH, int ROWS, int COLS>
__device__ __forceinline__ void sg_stage(float* dst, int ld,
                                         const float* __restrict__ src,
                                         int stride, int r0, int c0,
                                         int rows_in, int cols_in)
{
    constexpr int W = CH / 4;                   // words a chunk
    constexpr int PER_ROW = COLS / W;
    static_assert(ROWS * PER_ROW % SG_T == 0, "chunks fill the threads");
#pragma unroll
    for (int it = 0; it < ROWS * PER_ROW / SG_T; ++it) {
        const int i = it * SG_T + threadIdx.x;
        const int r = i / PER_ROW, c = (i % PER_ROW) * W;
        const bool in = r0 + r < rows_in && c0 + c < cols_in;
        cp_async<CH>(dst + r * ld + c,
                     in ? src + (size_t)(r0 + r) * stride + c0 + c : src,
                     in);
    }
}

// SCALE (k_bd): each row r of C is multiplied by 1 + (r mod G) once,
// as it is stored
template <bool NT, int CH, bool SCALE = false>
__device__ __forceinline__ void sgemm_ring(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, int M, int N, int K, int G = 1)
{
    extern __shared__ __align__(16) float sg_smem[];
    constexpr int STAGE = sg_stage_words(NT);
    const int tx = threadIdx.x % SG_TX, ty = threadIdx.x / SG_TX;
    const int m0 = blockIdx.y * SG_BM, n0 = blockIdx.x * SG_BN;
    const int nk = cdiv(K, SG_BK);

    auto load = [&](int slot, int kt) {
        float* As = sg_smem + slot * STAGE;
        float* Bs = As + SG_BM * SG_LDK;
        const int k0 = kt * SG_BK;
        sg_stage<CH, SG_BM, SG_BK>(As, SG_LDK, A, K, m0, k0, M, K);
        if constexpr (NT)
            sg_stage<CH, SG_BN, SG_BK>(Bs, SG_LDK, B, K, n0, k0, N, K);
        else
            sg_stage<CH, SG_BK, SG_BN>(Bs, SG_LDN, B, N, k0, n0, K, N);
    };

#pragma unroll
    for (int s = 0; s < SG_STAGES - 1; ++s) {
        if (s < nk) load(s, s);
        cp_async_commit();
    }

    float acc[4][4] = {};
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<SG_STAGES - 2>();        // slice kt has landed
        __syncthreads();
        if (kt + SG_STAGES - 1 < nk)
            load((kt + SG_STAGES - 1) % SG_STAGES, kt + SG_STAGES - 1);
        cp_async_commit();

        const float* As = sg_smem + (kt % SG_STAGES) * STAGE;
        const float* Bs = As + SG_BM * SG_LDK;
#pragma unroll
        for (int kk = 0; kk < SG_BK; kk += 4) {
            float a[4][4], b[4][4];            // a[row][k]; b[col][k] or b[k][col]
#pragma unroll
            for (int i = 0; i < 4; ++i)
                *reinterpret_cast<float4*>(a[i]) =
                    *reinterpret_cast<const float4*>(
                        &As[(ty + SG_TY * i) * SG_LDK + kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<float4*>(b[j]) =
                    NT ? *reinterpret_cast<const float4*>(
                             &Bs[(tx + SG_TX * j) * SG_LDK + kk])
                       : *reinterpret_cast<const float4*>(
                             &Bs[(kk + j) * SG_LDN + 4 * tx]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(a[i][q], NT ? b[j][q] : b[q][j],
                                         acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = m0 + ty + SG_TY * i;
        if (r >= M) continue;
        const float s = SCALE ? 1.f + (float)(r % G) : 1.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = n0 + (NT ? tx + SG_TX * j : 4 * tx + j);
            if (c < N) C[(size_t)r * N + c] = SCALE ? s * acc[i][j] : acc[i][j];
        }
    }
}

// The launch of sgemm_ring: its grid, chunk bytes (16 when K, for k_nn
// also N, is a multiple of 4 and A and B are 16-byte aligned, else 4)
// and dynamic shared memory
struct SgemmPlan {
    dim3 grid;
    int chunk, smem;
};

SgemmPlan sgemm_plan_of(bool nt, const void* A, const void* B, int M,
                        int N, int K)
{
    const bool vec = K % 4 == 0 && (nt || N % 4 == 0) && aligned16(A)
        && aligned16(B);
    return {dim3(cdiv(N, SG_BN), cdiv(M, SG_BM)), vec ? 16 : 4,
            SG_STAGES * sg_stage_words(nt) * (int)sizeof(float)};
}

// out (M, N) = ps (M, K) m (K, N): M = NF, N = TB, K = TC
template <int CH>
__global__ void __launch_bounds__(SG_T)
k_nn(const float* __restrict__ ps, const float* __restrict__ m,
     float* __restrict__ out, int M, int N, int K)
{
    sgemm_ring<false, CH>(ps, m, out, M, N, K);
}

// out (M, N) = ct (M, K) m (N, K)^T: M = NF, N = TC, K = TB
template <int CH>
__global__ void __launch_bounds__(SG_T)
k_nt(const float* __restrict__ ct, const float* __restrict__ m,
     float* __restrict__ out, int M, int N, int K)
{
    sgemm_ring<true, CH>(ct, m, out, M, N, K);
}

// Launch an instance of sgemm_ring (k_nn, k_nt or k_bd; NT true for
// k_nt: A = ct, B = m; else A = ps, B = m) for C (M, N) as
// sgemm_plan_of says; extra: the kernel's arguments after M, N, K
template <bool NT, typename Kernel, typename... Extra>
int launch_sgemm(Kernel k16, Kernel k4, const void* A, const void* B,
                 void* C, int M, int N, int K, cudaStream_t s,
                 Extra... extra)
{
    const SgemmPlan p = sgemm_plan_of(NT, A, B, M, N, K);
    auto kernel = p.chunk == 16 ? k16 : k4;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<p.grid, SG_T, p.smem, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(C), M, N, K, extra...);
    return (int)cudaGetLastError();
}

// out (M, N) = diag(1 + (r mod G)) ps (M, K) m (K, N): M = NF, N = TB,
// K = TC; k_nn's product with the row scale in its epilogue
template <int CH>
__global__ void __launch_bounds__(SG_T)
k_bd(const float* __restrict__ ps, const float* __restrict__ m,
     float* __restrict__ out, int M, int N, int K, int G)
{
    sgemm_ring<false, CH, true>(ps, m, out, M, N, K, G);
}

// ---- k_vt: the cluster-wide column sum (design in the header)
constexpr int VT_CL = 4, VT_GC = 16, VT_T = 256;
constexpr int VT_NW = VT_T / 32;                   // warps a block
static_assert(VT_GC % VT_CL == 0, "a block writes whole rows of out");
constexpr int VT_RPB = VT_GC / VT_CL;              // rows of out a block
// dynamic shared memory: the warps' partials [VT_NW][VT_GC], the block's
// [VT_GC], the sums of the block's rows of out [VT_RPB <= VT_GC]
constexpr int VT_SMEM = (VT_NW + 2) * VT_GC * (int)sizeof(float);

// The launch of k_vt: grid (a multiple of the cluster), cluster size,
// chunk bytes (16 when TC and TB are multiples of 4 and ps, m and out
// are 16-byte aligned, else 4) and dynamic shared memory
struct VtPlan {
    dim3 grid;
    int cluster, chunk, smem;
};

VtPlan vt_plan_of(const void* ps, const void* m, const void* out, int TC,
                  int TB)
{
    const bool vec = TC % 4 == 0 && TB % 4 == 0 && aligned16(ps)
        && aligned16(m) && aligned16(out);
    return {dim3(cdiv(TC, VT_GC) * VT_CL), VT_CL, vec ? 16 : 4, VT_SMEM};
}

template <int CH>
__global__ void __launch_bounds__(VT_T)
k_vt(const float* __restrict__ ps, const float* __restrict__ m,
     float* __restrict__ out, int NF, int TC, int TB)
{
    namespace cg = cooperative_groups;
    constexpr int W = CH / 4;                      // columns a load
    constexpr int LPR = VT_GC / W;                 // threads across a row
    constexpr int RPP = VT_T / LPR;                // rows a pass
    extern __shared__ __align__(16) float vt_smem[];
    float* wpart = vt_smem;
    float* part = wpart + VT_NW * VT_GC;
    float* srow = part + VT_GC;
    const cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int c0 = (int)(blockIdx.x / VT_CL) * VT_GC;
    const int tx = threadIdx.x % LPR, ty = threadIdx.x / LPR;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

    // this block's rows j of the group's columns, in j order
    const int rows = cdiv(NF, VT_CL);
    const int j1 = min(NF, (rank + 1) * rows);
    const int c = c0 + tx * W;
    float acc[W] = {};
    if (c < TC) {
#pragma unroll 4
        for (int j = rank * rows + ty; j < j1; j += RPP) {
            const float* p = ps + (size_t)j * TC + c;
            if constexpr (CH == 16) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(p));
                acc[0] += v.x;
                acc[1] += v.y;
                acc[2] += v.z;
                acc[3] += v.w;
            } else {
                acc[0] += __ldg(p);
            }
        }
    }
    // the lanes of a column by xor shuffles, then the warps in order
#pragma unroll
    for (int off = 16; off >= LPR; off >>= 1)
#pragma unroll
        for (int w = 0; w < W; ++w)
            acc[w] += __shfl_xor_sync(0xffffffffu, acc[w], off);
    if (lane < LPR)
#pragma unroll
        for (int w = 0; w < W; ++w)
            wpart[warp * VT_GC + lane * W + w] = acc[w];
    __syncthreads();
    if (threadIdx.x < VT_GC) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < VT_NW; ++k)
            s += wpart[k * VT_GC + threadIdx.x];
        part[threadIdx.x] = s;
    }

    // the column sums of this block's rows of out, from every rank's
    // partial in rank order
    cluster.sync();
    if (threadIdx.x < VT_RPB) {
        const int cc = rank * VT_RPB + threadIdx.x;
        float s = 0.f;
        for (int r = 0; r < VT_CL; ++r)
            s += cluster.map_shared_rank(part, r)[cc];
        srow[threadIdx.x] = s;
    }
    // this block reads no other block's shared memory past here
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
    __syncthreads();

    // out[c, :] = s[c] m[c, :] for this block's rows, along b
    const int PR = TB / W;                         // chunks a row
    const int r0 = c0 + rank * VT_RPB;
    for (int i = threadIdx.x; i < VT_RPB * PR; i += VT_T) {
        const int rr = i / PR, cr = r0 + rr;
        if (cr >= TC) continue;
        const float s = srow[rr];
        const size_t o = (size_t)cr * TB + (i % PR) * W;
        if constexpr (CH == 16) {
            float4 v = __ldg(reinterpret_cast<const float4*>(m + o));
            v.x *= s;
            v.y *= s;
            v.z *= s;
            v.w *= s;
            *reinterpret_cast<float4*>(out + o) = v;
        } else {
            out[o] = s * __ldg(m + o);
        }
    }
    // no block exits while another may still read its partial
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ---- k_lr: the lane-split product (design in the header)
constexpr int LR_BM = 32, LR_BN = 32, LR_BK = 64, LR_STAGES = 2, LR_S = 8,
              LR_TI = 8, LR_TJ = 8;
constexpr int LR_T = SG_T;                 // 128 threads (sg_stage's count)
constexpr int LR_RY = LR_BM / LR_TI, LR_CX = LR_BN / LR_TJ;
constexpr int LR_N = LR_TI * LR_TJ;        // partial sums a lane
constexpr int LR_LD = LR_BK + 16;          // words a row: 16 banks apart
constexpr int LR_STAGE = (LR_BM + LR_BN) * LR_LD;
static_assert(LR_RY * LR_CX * LR_S == LR_T, "lanes cover the tile");
static_assert(LR_BK % (4 * LR_S) == 0 && 32 % LR_S == 0, "lane split");
static_assert(LR_N % LR_S == 0, "each lane stores whole outputs");

// The launch of k_lr: grid, chunk bytes (16 when TB is a multiple of 4
// and ct and m are 16-byte aligned, else 4) and dynamic shared memory
struct LrPlan {
    dim3 grid;
    int chunk, smem;
};

LrPlan lr_plan_of(const void* ct, const void* m, int NF, int TB, int TC)
{
    const bool vec = TB % 4 == 0 && aligned16(ct) && aligned16(m);
    return {dim3(cdiv(TC, LR_BN), cdiv(NF, LR_BM)), vec ? 16 : 4,
            LR_STAGES * LR_STAGE * (int)sizeof(float)};
}

// One step of the reduce-scatter over the LR_S lanes of an output: the
// lane with bit STEP of q set keeps the upper H of its values, the other
// the lower, each adding its partner's; then the next step
template <int STEP, int H>
__device__ __forceinline__ void lr_scatter(float (&acc)[LR_N], int q)
{
    if constexpr (STEP < LR_S) {
        const bool up = (q & STEP) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float send = up ? acc[i] : acc[i + H];
            const float keep = up ? acc[i + H] : acc[i];
            acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, STEP);
        }
        lr_scatter<2 * STEP, H / 2>(acc, q);
    }
}

template <int CH>
__global__ void __launch_bounds__(LR_T)
k_lr(const float* __restrict__ ct, const float* __restrict__ m,
     float* __restrict__ out, int NF, int TB, int TC)
{
    extern __shared__ __align__(16) float lr_smem[];
    const int q = threadIdx.x % LR_S, g = threadIdx.x / LR_S;
    const int cx = g % LR_CX, ry = g / LR_CX;
    const int m0 = blockIdx.y * LR_BM, n0 = blockIdx.x * LR_BN;
    const int nk = cdiv(TB, LR_BK);

    auto stage = [&](int slot, int kt) {
        float* As = lr_smem + slot * LR_STAGE;
        float* Bs = As + LR_BM * LR_LD;
        const int k0 = kt * LR_BK;
        sg_stage<CH, LR_BM, LR_BK>(As, LR_LD, ct, TB, m0, k0, NF, TB);
        sg_stage<CH, LR_BN, LR_BK>(Bs, LR_LD, m, TB, n0, k0, TC, TB);
    };
#pragma unroll
    for (int s = 0; s < LR_STAGES - 1; ++s) {
        if (s < nk) stage(s, s);
        cp_async_commit();
    }

    float acc[LR_N] = {};
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<LR_STAGES - 2>();        // slice kt has landed
        __syncthreads();
        if (kt + LR_STAGES - 1 < nk)
            stage((kt + LR_STAGES - 1) % LR_STAGES, kt + LR_STAGES - 1);
        cp_async_commit();

        const float* As = lr_smem + (kt % LR_STAGES) * LR_STAGE
            + ry * LR_LD + 4 * q;
        const float* Bs = lr_smem + (kt % LR_STAGES) * LR_STAGE
            + LR_BM * LR_LD + cx * LR_LD + 4 * q;
#pragma unroll
        for (int kk = 0; kk < LR_BK; kk += 4 * LR_S) {
            float a[LR_TI][4], b[LR_TJ][4];    // a[row][b], b[column][b]
#pragma unroll
            for (int i = 0; i < LR_TI; ++i)
                *reinterpret_cast<float4*>(a[i]) =
                    *reinterpret_cast<const float4*>(
                        &As[LR_RY * i * LR_LD + kk]);
#pragma unroll
            for (int j = 0; j < LR_TJ; ++j)
                *reinterpret_cast<float4*>(b[j]) =
                    *reinterpret_cast<const float4*>(
                        &Bs[LR_CX * j * LR_LD + kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int i = 0; i < LR_TI; ++i)
#pragma unroll
                    for (int j = 0; j < LR_TJ; ++j)
                        acc[i * LR_TJ + j] = fmaf(a[i][e], b[j][e],
                                                  acc[i * LR_TJ + j]);
        }
    }

    lr_scatter<1, LR_N / 2>(acc, q);
    // lane q now holds values start .. start + LR_N / LR_S - 1 of the 64
    int start = 0;
#pragma unroll
    for (int s = 1, h = LR_N / 2; s < LR_S; s *= 2, h /= 2)
        if (q & s) start += h;
#pragma unroll
    for (int e = 0; e < LR_N / LR_S; ++e) {
        const int idx = start + e;
        const int r = m0 + ry + LR_RY * (idx / LR_TJ);
        const int c = n0 + cx + LR_CX * (idx % LR_TJ);
        if (r < NF && c < TC) out[(size_t)r * TC + c] = acc[e];
    }
}

// ---- k_rot: A_NF m (rho m)^NF by a float-float power (header)
constexpr int ROT_T = 256;             // threads a block

// h + l, |l| <= ~ulp(h) / 2: a float32 pair of ~48 bits
struct FF {
    float h, l;
};

// a times b (a float32), within ~2^-46 of the exact product; h is the
// float32 rounding of the result
__device__ __forceinline__ FF ff_mul1(FF a, float b)
{
    const float t = __fmul_rn(a.l, b);
    const float h = __fmaf_rn(a.h, b, t);
    return {h, __fadd_rn(__fmaf_rn(a.h, b, -h), t)};
}

// a times b, within ~2^-45 (the l l term is dropped)
__device__ __forceinline__ FF ff_mul(FF a, FF b)
{
    const float t = __fmaf_rn(a.h, b.l, __fmul_rn(a.l, b.h));
    const float h = __fmaf_rn(a.h, b.h, t);
    return {h, __fadd_rn(__fmaf_rn(a.h, b.h, -h), t)};
}

// a squared, within ~2^-45
__device__ __forceinline__ FF ff_sqr(FF a)
{
    const float t = __fmul_rn(a.h, __fadd_rn(a.l, a.l));
    const float h = __fmaf_rn(a.h, a.h, t);
    return {h, __fadd_rn(__fmaf_rn(a.h, a.h, -h), t)};
}

// v[e] <- A_NF v[e] (rho v[e])^NF, a = A_NF and rho as float pairs:
// right-to-left binary powering, the V elements' chains interleaved
template <int V>
__device__ __forceinline__ void rot_pow(float (&v)[V], unsigned NF, FF a,
                                        FF rho)
{
    FF r[V], b[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
        r[e] = ff_mul1(a, v[e]);
        b[e] = ff_mul1(rho, v[e]);
    }
    unsigned k = NF;
#pragma unroll 4
    for (; k > 1; k >>= 1) {
        if (k & 1) {
#pragma unroll
            for (int e = 0; e < V; ++e) r[e] = ff_mul(r[e], b[e]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) b[e] = ff_sqr(b[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = k ? ff_mul(r[e], b[e]).h : r[e].h;
}

// group g of V elements: V / 4 float4s, or one float
template <int V>
__device__ __forceinline__ void rot_load(float (&v)[V],
                                         const float* __restrict__ m, int g)
{
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
            const float4 x = reinterpret_cast<const float4*>(m)[g * (V / 4) + q];
            v[4 * q] = x.x;
            v[4 * q + 1] = x.y;
            v[4 * q + 2] = x.z;
            v[4 * q + 3] = x.w;
        }
    } else {
        v[0] = m[g];
    }
}

template <int V>
__device__ __forceinline__ void rot_store(float* __restrict__ out, int g,
                                          const float (&v)[V])
{
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
            reinterpret_cast<float4*>(out)[g * (V / 4) + q] = make_float4(
                v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
        out[g] = v[0];
    }
}

// V elements a thread (4 when m and out are 16-byte aligned, else 1),
// grid-stride over the n / V groups, each group's load issued before
// the previous group's power; the first block takes the n % V left over
template <int V>
__global__ void __launch_bounds__(ROT_T)
k_rot(const float* __restrict__ m, float* __restrict__ out, int n, int NF,
      float a_hi, float a_lo, float rho_hi, float rho_lo)
{
    static_assert(V == 1 || V % 4 == 0, "one element or float4s a thread");
    const FF a = {a_hi, a_lo}, rho = {rho_hi, rho_lo};
    const int groups = n / V, stride = gridDim.x * ROT_T;
    int g = blockIdx.x * ROT_T + threadIdx.x;
    float next[V];
    if (g < groups) rot_load<V>(next, m, g);
    for (; g < groups; g += stride) {
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = next[e];
        if (g + stride < groups) rot_load<V>(next, m, g + stride);
        rot_pow<V>(v, (unsigned)NF, a, rho);
        rot_store<V>(out, g, v);
    }
    if (V > 1 && blockIdx.x == 0 && threadIdx.x < n - groups * V) {
        const int i = groups * V + threadIdx.x;
        float v[1] = {m[i]};
        rot_pow<1>(v, (unsigned)NF, a, rho);
        out[i] = v[0];
    }
}

// ---- k_fwd: the forward loop in rime_fwd.cu's design (header)
constexpr int FW_TN = 32;              // columns b a block (lanes of a warp)
constexpr int FW_RG = 8;               // runs a block (a warp each)
constexpr int FW_RT = 32;              // rows k a run
constexpr int FW_CH = 4;               // chains of a run
constexpr int FW_TK = 32;              // c a tile
constexpr int FW_MS = 8;               // slices of c, at most
constexpr int FW_WAVE = 2 * 132;       // blocks resident: two an SM, 132 SMs
constexpr int FW_T = FW_TN * FW_RG;
constexpr int FW_TR = FW_RG * FW_RT;   // rows a block
constexpr int FW_LD = FW_TR + 4;       // words a staged c-row of ps
// a slot of the staging ring: ps [c][row], tau [c][b]
constexpr int FW_SLOT = FW_TK * FW_LD + FW_TK * FW_TN;
// dynamic shared memory: two slots and the step table [c][b] (float4)
constexpr int FW_SMEM = 4 * (2 * FW_SLOT + 4 * FW_TK * FW_TN);
static_assert(FW_RT % FW_CH == 0 && FW_RT >= 2 * FW_CH && FW_CH >= 2
              && (FW_CH & (FW_CH - 1)) == 0 && FW_CH <= 16, "chains");
// 2 pi = FW_P1 + FW_P2 + FW_P3; FW_P1 has 8 significant bits, so q FW_P1
// is exact for |q| < 2^16
constexpr float FW_P1 = 6.28125f;
constexpr float FW_P2 = 1.9353072e-3f;
constexpr float FW_P3 = 1.0253132e-11f;
constexpr float FW_INV2PI = 0.159154943f;

// The launch of k_fwd: grid (columns, rows, slices S of c), c a slice
// (whole tiles) and dynamic shared memory. S minimises waves / S (ties:
// fewer), so that the blocks fill whole waves of FW_WAVE.
struct FwdPlan {
    dim3 grid;
    int cslice, smem;
};

FwdPlan fwd_plan_of(int NF, int TC, int TB)
{
    const int tiles = cdiv(TB, FW_TN) * cdiv(NF, FW_TR);
    const int ntk = std::max(1, cdiv(TC, FW_TK));
    int best = 1;
    for (int s = 2; s <= std::min(FW_MS, ntk); ++s)
        if (cdiv(tiles * s, FW_WAVE) * best
            < cdiv(tiles * best, FW_WAVE) * s)
            best = s;
    const int cslice = cdiv(ntk, best) * FW_TK;
    return {dim3(cdiv(TB, FW_TN), cdiv(NF, FW_TR),
                 std::max(1, cdiv(TC, cslice))),
            cslice, FW_SMEM};
}

// sin and cos of x, |x| < 1e5, to a few ulp: x - j pi/2 in three parts
// (CUDA's own split), minimax polynomials on [-pi/4, pi/4] (Cephes'
// sinf / cosf), the quadrant j mod 4. sincosf also carries a
// Payne-Hanek path for huge x, with a stack frame and FP64.
__device__ __forceinline__ void fw_sincos(float x, float& s, float& c)
{
    const float j = rintf(x * 0.636619747f);
    float r = fmaf(-j, 1.57079625f, x);
    r = fmaf(-j, 7.54978942e-8f, r);
    r = fmaf(-j, 5.39030253e-15f, r);
    const float r2 = r * r;
    float ps = fmaf(r2, -1.95152959e-4f, 8.33216087e-3f);
    ps = fmaf(r2, ps, -1.66666546e-1f);
    const float sr = fmaf(r * r2, ps, r);
    float pc = fmaf(r2, 2.44331571e-5f, -1.38873163e-3f);
    pc = fmaf(r2, pc, 4.16666456e-2f);
    pc = fmaf(r2, pc, -0.5f);
    const float cr = fmaf(r2, pc, 1.f);
    const int q = (int)j & 3;
    s = (q & 1) ? cr : sr;
    c = (q & 1) ? sr : cr;
    if (q & 2) s = -s;
    if ((q + 1) & 2) c = -c;
}

// the highest set bit of g > 0 (a constant where g is)
__host__ __device__ constexpr int fw_hbit(int g)
{
    return g >= 8 ? 3 : g >= 4 ? 2 : g >= 2 ? 1 : 0;
}

// e^{i k t}: k t = x + xe exactly, x - q 2 pi taken in three parts (the
// first exact), then the SFU on [-pi, pi]
__device__ __forceinline__ void fw_seed(float k, float t, float& c, float& s)
{
    const float x = __fmul_rn(k, t), xe = fmaf(k, t, -x);
    const float q = rintf(x * FW_INV2PI);
    const float hi = fmaf(-q, FW_P1, x);
    const float lo = fmaf(-q, FW_P3, fmaf(-q, FW_P2, xe));
    __sincosf(hi + lo, &s, &c);
}

__global__ void __launch_bounds__(FW_T, 2)
k_fwd(const float* __restrict__ tau, const float* __restrict__ ps,
      float* __restrict__ ore, float* __restrict__ oim,
      float* __restrict__ part, int TC, int TB, int NF, int cslice)
{
    extern __shared__ __align__(16) float fw_smem[];
    float4* tab = reinterpret_cast<float4*>(fw_smem + 2 * FW_SLOT);
    const int tid = threadIdx.x;
    const int tx = tid % FW_TN, ty = tid / FW_TN;
    const int b0 = blockIdx.x * FW_TN, row0 = blockIdx.y * FW_TR;
    const int k0 = row0 + ty * FW_RT;
    const float k0f = (float)k0;
    const int c_begin = blockIdx.z * cslice;
    const int c_end = min(TC, c_begin + cslice);
    const int ntile = cdiv(c_end - c_begin, FW_TK);

    // tile it of the slice into slot: ps transposed to [c][row] by 4-byte
    // copies (a warp reads 32 consecutive c of a row), tau along b; zeros
    // past NF, TB and the slice
    auto stage = [&](int slot, int it) {
        float* ps_s = fw_smem + slot * FW_SLOT;
        float* tau_s = ps_s + FW_TK * FW_LD;
        const int ct = c_begin + it * FW_TK;
#pragma unroll 8
        for (int m = 0; m < FW_TR * FW_TK / FW_T; ++m) {
            const int i = m * FW_T + tid, r = i / FW_TK, c = i % FW_TK;
            const bool in = row0 + r < NF && ct + c < c_end;
            cp_async<4>(ps_s + c * FW_LD + r,
                        in ? ps + (size_t)(row0 + r) * TC + ct + c : ps, in);
        }
#pragma unroll
        for (int m = 0; m < FW_TK * FW_TN / FW_T; ++m) {
            const int i = m * FW_T + tid, c = i / FW_TN, n = i % FW_TN;
            const bool in = ct + c < c_end && b0 + n < TB;
            cp_async<4>(tau_s + i,
                        in ? tau + (size_t)(ct + c) * TB + b0 + n : tau, in);
        }
    };

    float acc_re[FW_RT], acc_im[FW_RT];
#pragma unroll
    for (int r = 0; r < FW_RT; ++r) {
        acc_re[r] = 0.f;
        acc_im[r] = 0.f;
    }
    if (ntile > 0) stage(0, 0);
    cp_async_commit();
    for (int it = 0; it < ntile; ++it) {
        cp_async_wait<0>();                    // tile it has landed
        __syncthreads();                       // and every thread left it - 1
        if (it + 1 < ntile) stage((it + 1) % 2, it + 1);
        cp_async_commit();
        const float* ps_s = fw_smem + (it % 2) * FW_SLOT;
        const float* tau_s = ps_s + FW_TK * FW_LD;

        // the tile's steps, shared by the block's runs: D = e^{i t} and
        // D^CH = e^{i CH t} (CH t is exact), to a few ulp
#pragma unroll
        for (int m = 0; m < FW_TK * FW_TN / FW_T; ++m) {
            const int i = m * FW_T + tid;
            const float t = tau_s[i];
            float s1, c1, sn, cn;
            fw_sincos(t, s1, c1);
            fw_sincos((float)FW_CH * t, sn, cn);
            tab[i] = make_float4(c1, s1, cn, sn);
        }
        __syncthreads();

        if (k0 < NF) {                         // uniform over the warp
            const int kmax = min(FW_TK, c_end - c_begin - it * FW_TK);
            for (int cc = 0; cc < kmax; ++cc) {
                const float4 D = tab[cc * FW_TN + tx];
                // rows 0 .. CH - 1 from the seed by D^(2^h) (squares of
                // D), rows CH .. 2 CH - 1 from those by D^CH
                float ec[2 * FW_CH], es[2 * FW_CH];
                float pc[4], pw[4];
                pc[0] = D.x;
                pw[0] = D.y;
#pragma unroll
                for (int h = 1; (1 << h) < FW_CH; ++h) {
                    pc[h] = fmaf(pc[h - 1], pc[h - 1], -pw[h - 1] * pw[h - 1]);
                    pw[h] = 2.f * pc[h - 1] * pw[h - 1];
                }
                fw_seed(k0f, tau_s[cc * FW_TN + tx], ec[0], es[0]);
#pragma unroll
                for (int g = 1; g < FW_CH; ++g) {
                    const int h = fw_hbit(g), f = g - (1 << h);
                    ec[g] = fmaf(ec[f], pc[h], -es[f] * pw[h]);
                    es[g] = fmaf(es[f], pc[h], ec[f] * pw[h]);
                }
#pragma unroll
                for (int g = 0; g < FW_CH; ++g) {
                    ec[FW_CH + g] = fmaf(ec[g], D.z, -es[g] * D.w);
                    es[FW_CH + g] = fmaf(es[g], D.z, ec[g] * D.w);
                }
                // CH chains over rows g + CH j: e_{j+1} = 2 Re(D^CH) e_j -
                // e_{j-1}, one FMA a component and row
                const float w = 2.f * D.z;
                const float4* pr = reinterpret_cast<const float4*>(
                    ps_s + cc * FW_LD + ty * FW_RT);
                float4 p4;
#pragma unroll
                for (int j = 0; j < FW_RT / FW_CH; ++j) {
                    if (j >= 2) {
#pragma unroll
                        for (int g = 0; g < FW_CH; ++g) {
                            const float nc = fmaf(w, ec[FW_CH + g], -ec[g]);
                            const float ns = fmaf(w, es[FW_CH + g], -es[g]);
                            ec[g] = ec[FW_CH + g];
                            es[g] = es[FW_CH + g];
                            ec[FW_CH + g] = nc;
                            es[FW_CH + g] = ns;
                        }
                    }
                    const int g0 = j == 0 ? 0 : FW_CH;
#pragma unroll
                    for (int g = 0; g < FW_CH; ++g) {
                        const int r = j * FW_CH + g;
                        if (r % 4 == 0) p4 = pr[r / 4];
                        const float p = r % 4 == 0 ? p4.x
                            : r % 4 == 1 ? p4.y : r % 4 == 2 ? p4.z : p4.w;
                        acc_re[r] = fmaf(p, ec[g0 + g], acc_re[r]);
                        acc_im[r] = fmaf(p, es[g0 + g], acc_im[r]);
                    }
                }
            }
        }
    }

    // this slice's sums: straight to the output when the plan has one
    // slice, else to slice z of the scratch part [z][re, im][k][b], which
    // fw_sum adds in order
    if (k0 < NF && b0 + tx < TB) {
        const size_t count = (size_t)NF * TB;
        float* re = gridDim.z == 1 ? ore : part + blockIdx.z * 2 * count;
        float* im = gridDim.z == 1 ? oim : re + count;
#pragma unroll
        for (int r = 0; r < FW_RT; ++r) {
            if (k0 + r < NF) {
                const size_t o = (size_t)(k0 + r) * TB + b0 + tx;
                re[o] = acc_re[r];
                im[o] = acc_im[r];
            }
        }
    }
}

// ore, oim = the S slices of part ([z][re, im][count]) added in order
template <int V>
__global__ void __launch_bounds__(256)
fw_sum(const float* __restrict__ part, float* __restrict__ ore,
       float* __restrict__ oim, size_t count, int S)
{
    using T = typename std::conditional<V == 4, float4, float>::type;
    const size_t m = count / V;                // vectors a plane
    const T* p = reinterpret_cast<const T*>(part);
    for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < 2 * m;
         i += (size_t)gridDim.x * 256) {
        T a = p[i];
        for (int z = 1; z < S; ++z) {
            const T b = p[z * 2 * m + i];
            if constexpr (V == 4) {
                a.x += b.x;
                a.y += b.y;
                a.z += b.z;
                a.w += b.w;
            } else {
                a += b;
            }
        }
        reinterpret_cast<T*>(i < m ? ore : oim)[i % m] = a;
    }
}

}  // namespace

// C launchers: each launches on `stream` and returns cudaGetLastError()
// (0 on success). Shapes as in the header.
extern "C" int k_nn_launch(const void* ps, const void* m, void* out, int NF,
                           int TC, int TB, void* stream)
{
    return launch_sgemm<false>(k_nn<16>, k_nn<4>, ps, m, out, NF, TB, TC,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int k_nt_launch(const void* ct, const void* m, void* out, int NF,
                           int TB, int TC, void* stream)
{
    return launch_sgemm<true>(k_nt<16>, k_nt<4>, ct, m, out, NF, TC, TB,
                              static_cast<cudaStream_t>(stream));
}

// The launch that k_nn_launch (nt = 0: A = ps, B = m) or k_nt_launch (nt
// = 1: A = ct, B = m) makes for C (M, N) = A B or A B^T: grid.x, grid.y,
// chunk bytes and dynamic shared memory (the card's check of
// the wrapper's sgemm_plan). Touches no memory.
extern "C" int sgemm_plan(int nt, const void* A, const void* B, int M,
                          int N, int K, int* gx, int* gy, int* chunk,
                          int* smem)
{
    const SgemmPlan p = sgemm_plan_of(nt != 0, A, B, M, N, K);
    *gx = (int)p.grid.x;
    *gy = (int)p.grid.y;
    *chunk = p.chunk;
    *smem = p.smem;
    return 0;
}

extern "C" int k_vt_launch(const void* ps, const void* m, void* out, int NF,
                           int TC, int TB, void* stream)
{
    const VtPlan p = vt_plan_of(ps, m, out, TC, TB);
    auto kernel = p.chunk == 16 ? k_vt<16> : k_vt<4>;
    if (p.cluster > 8) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = p.grid;
    cfg.blockDim = dim3(VT_T);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const float*>(ps),
        static_cast<const float*>(m), static_cast<float*>(out), NF, TC, TB);
    if (err != cudaSuccess) return (int)err;
    return static_cast<int>(cudaGetLastError());
}

// The launch that k_vt_launch makes: grid.x, cluster size, chunk bytes
// and dynamic shared memory (the card's check of the wrapper's
// vt_plan). Touches no memory.
extern "C" int vt_plan(const void* ps, const void* m, const void* out,
                       int NF, int TC, int TB, int* gx, int* cluster,
                       int* chunk, int* smem)
{
    (void)NF;
    const VtPlan p = vt_plan_of(ps, m, out, TC, TB);
    *gx = (int)p.grid.x;
    *cluster = p.cluster;
    *chunk = p.chunk;
    *smem = p.smem;
    return 0;
}

extern "C" int k_lr_launch(const void* ct, const void* m, void* out, int NF,
                           int TB, int TC, void* stream)
{
    const LrPlan p = lr_plan_of(ct, m, NF, TB, TC);
    auto kernel = p.chunk == 16 ? k_lr<16> : k_lr<4>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<p.grid, LR_T, p.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ct), static_cast<const float*>(m),
        static_cast<float*>(out), NF, TB, TC);
    return static_cast<int>(cudaGetLastError());
}

// The launch that k_lr_launch makes: grid.x, grid.y, chunk bytes and
// dynamic shared memory (the card's check of the wrapper's lr_plan).
// Touches no memory.
extern "C" int lr_plan(const void* ct, const void* m, int NF, int TB, int TC,
                       int* gx, int* gy, int* chunk, int* smem)
{
    const LrPlan p = lr_plan_of(ct, m, NF, TB, TC);
    *gx = (int)p.grid.x;
    *gy = (int)p.grid.y;
    *chunk = p.chunk;
    *smem = p.smem;
    return 0;
}

// k_bd launches sgemm_ring as k_nn does (its plan is sgemm_plan's with
// nt = 0, M = NF, N = TB, K = TC); G >= 1
extern "C" int k_bd_launch(const void* ps, const void* m, void* out, int NF,
                           int TC, int TB, int G, void* stream)
{
    if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_sgemm<false>(k_bd<16>, k_bd<4>, ps, m, out, NF, TB, TC,
                               static_cast<cudaStream_t>(stream), G);
}

// k_rot on n >= 1 elements; NF >= 0, (a_hi, a_lo) = A_NF and (rho_hi,
// rho_lo) = sqrt(0.82) as float pairs (scripts/mosaic_spike.py::
// rot_consts). 4 elements a thread when m and out are 16-byte aligned,
// else 1, over one wave of resident blocks (fewer when n / V needs
// fewer).
extern "C" int k_rot_launch(const void* m, void* out, int n, int NF,
                            float a_hi, float a_lo, float rho_hi,
                            float rho_lo, void* stream)
{
    if (n < 1 || NF < 0) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = aligned16(m) && aligned16(out);
    const int V = vec ? 4 : 1;
    auto kernel = vec ? k_rot<4> : k_rot<1>;
    static int wave[2] = {0, 0};       // blocks of a full wave, by vec
    if (wave[vec] == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, ROT_T, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
        wave[vec] = std::max(1, sms * per_sm);
    }
    const int grid = std::max(1, std::min(cdiv(n / V, ROT_T), wave[vec]));
    kernel<<<grid, ROT_T, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(m), static_cast<float*>(out), n, NF, a_hi,
        a_lo, rho_hi, rho_lo);
    return static_cast<int>(cudaGetLastError());
}

// k_fwd as fwd_plan_of says, then (S > 1) fw_sum; part holds S * 2 * NF
// * TB floats (unused for S = 1)
extern "C" int k_fwd_launch(const void* tau, const void* ps, void* ore,
                            void* oim, void* part, int TC, int TB, int NF,
                            void* stream)
{
    const FwdPlan p = fwd_plan_of(NF, TC, TB);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        k_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    float* re = static_cast<float*>(ore);
    float* im = static_cast<float*>(oim);
    float* pt = static_cast<float*>(part);
    k_fwd<<<p.grid, FW_T, p.smem, s>>>(static_cast<const float*>(tau),
                                       static_cast<const float*>(ps), re, im,
                                       pt, TC, TB, NF, p.cslice);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.grid.z == 1) return (int)err;
    const size_t count = (size_t)NF * TB;
    const int V = count % 4 == 0 ? 4 : 1;
    const unsigned blocks =
        (unsigned)std::min<size_t>((2 * count / V + 255) / 256, 4096);
    if (V == 4)
        fw_sum<4><<<blocks, 256, 0, s>>>(pt, re, im, count, (int)p.grid.z);
    else
        fw_sum<1><<<blocks, 256, 0, s>>>(pt, re, im, count, (int)p.grid.z);
    return (int)cudaGetLastError();
}

// The launch that k_fwd_launch makes: grid.x, grid.y, grid.z (the
// slices), c a slice and dynamic shared memory (the card's check of the
// wrapper's fwd_plan). Touches no memory.
extern "C" int fwd_plan(int NF, int TC, int TB, int* gx, int* gy, int* gz,
                        int* cslice, int* smem)
{
    const FwdPlan p = fwd_plan_of(NF, TC, TB);
    *gx = (int)p.grid.x;
    *gy = (int)p.grid.y;
    *gz = (int)p.grid.z;
    *cslice = p.cslice;
    *smem = p.smem;
    return 0;
}
