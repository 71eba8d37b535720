#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py route [PREFIX ...]  # the build and the moe_route
                                  # phase (the cases whose label starts
                                  # with a PREFIX, all without one)
    python3 chip_smoke.py norm    # the build and the rmsnorm cases
    python3 chip_smoke.py compare [KERNEL ...]  # the build, then for
                                  # each of rmsnorm, moe_route, rwkv_scan,
                                  # mamba_scan, flash_attention and
                                  # flash_attention_bwd named (all without
                                  # one) its cases and its path's profile
                                  # (the router: its path, jamba, large and
                                  # tie cases, the MoE path; flash: its
                                  # cases only); no launch log, and the
                                  # cases a tree refuses skipped: runs
                                  # over an older tree's src/ too
    python3 chip_smoke.py moe     # the build, the MoE path and its profile
    python3 chip_smoke.py rwkv    # the build, rwkv_scan, the RWKV path
    python3 chip_smoke.py mamba   # the build, jamba's kernel shapes,
                                  # mamba_scan, the Mamba path
    python3 chip_smoke.py scan-tiles  # the build, both scans under every
                                  # lane tile at their paths' admissions
                                  # and large shapes
    python3 chip_smoke.py prefill # the build, the paged kernels' cases,
                                  # the teacher-forced check
    python3 chip_smoke.py attention  # the build, every attention kernel's
                                  # cases, the teacher-forced check
    python3 chip_smoke.py modes   # the build, the verify-shape paged
                                  # prefill cases, threefry, paths E, T,
                                  # S1-S3, the verify pass teacher-forced,
                                  # the new paths' profiles
    python3 chip_smoke.py tier    # the build, the host tier's paths
                                  # W1-W7, its transfers, W1 against
                                  # recompute profiled
    python3 chip_smoke.py fleet   # the build, paths A and C, the fleet's
                                  # paths FL1-FL5, the handoff cost, the
                                  # fleet profiled
    python3 chip_smoke.py zoo     # the build, the kernels at the zoo's
                                  # head shapes, mixtral's router rows,
                                  # the zoo's paths Z1-Z7
    python3 chip_smoke.py train   # the build and the training phase: the
                                  # flash backward's cases, the grad
                                  # guard, TR1-TR3
    python3 chip_smoke.py bwd     # the build and the flash backward's
                                  # cases only
    python3 chip_smoke.py bwd-chunks  # the build, the backward's dkdv
                                  # chunk swept at its timed cases
    python3 chip_smoke.py mesh    # the build, the kernels at the mesh's
                                  # local shapes, the unsharded paths, the
                                  # mesh phase
    python3 chip_smoke.py mesh-zoo  # the build, the zoo's kernels at a
                                  # 1x2 rank's local shapes, MZ1-MZ3, MZT
                                  # and FLM
    python3 chip_smoke.py mesh-train  # the build, the kernels at the
                                  # training mesh's local shapes, MT1-MT3

Phases, each raising on failure (nothing is caught; any failure exits
non-zero before the result line):

1. build  — ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a into
   one library (all sources at once), timed; ptxas's registers, spills and
   static shared memory per kernel, and the dynamic shared memory and
   blocks per SM of each instantiation of the flash, slot decode, paged
   decode and paged prefill kernels; the launch geometry that rmsnorm,
   moe_route, rwkv_scan and mamba_scan choose at the paths' and the
   sweeps' shapes, with the router's and the scans' dynamic shared memory
   and the blocks of each that fit an SM.
2. kernels — every hand-written kernel against its plain PyTorch version on
   the card, at the main paths' shapes (full-width tinyllama-1.1b: D=2048,
   HQ=32, HKV=4, dh=64; 4 slots, prompt 32, gen 32, max_len 72; the
   ``--load seq`` shape, batch 1, through the uniform ``decode_attention``
   wrapper with its mask built from slot_pos/pos; paged decode over pools
   (22,16,4,64) through permuted tables with trash tails; paged prefill
   chunks of 24 starting mid-block) and over a sweep (HKV=3, odd dh, a
   sliding window, non-power-of-two lengths, block sizes 8 and 16, chunks
   of 1, 7 and to a block boundary, paged prefill at W=1 against paged
   decode and at dh 36 and 256, which take every copy width of its
   staging), in float32 (atol = rtol = 1e-4) and bfloat16 (2e-2); rmsnorm
   also at decode rows of D 7168 and 12288 (several warps a row), at
   (4096, 2048) with a bf16 scale, at (16384, 4096), whose input and output
   are larger than the 50 MB L2, and at a row of 70001 (wider than a
   block's registers: streamed twice); rmsnorm,
   flash attention and slot decode also at the MoE path's shapes
   (moonshot-v1-16b-a3b: D 2048, HQ = HKV = 16, dh 128, G = 1) and at the
   Mamba path's (jamba-v0.1-52b: D 4096, HQ 32, HKV 8, dh 128, G = 4); at
   2048 tokens flash attention also runs at those two paths' head shapes
   and with a 512-token window, and slot decode over 32 slots of 2048 keys
   at moonshot's head shape and with ragged occupancy (0, 1, 700 and 2048
   live keys). A slot or paged decode case's label ends with the number
   of splits the wrapper cuts its cache into. Paged decode also runs over
   blocks of 24 (key tiles that line up with no block), in four splits
   two of which hold no valid key, over pools whose trash row, spare
   blocks and stale chain tails hold NaN (NaN codes and scales when
   quantized; the plain version gets the same pools with those positions
   zeroed, so a kernel that read one would disagree), and over 32 slots
   of 2048 keys at jamba's head shape and with ragged occupancy. The
   fused-dequant paged kernels (``paged_decode_quant``,
   ``paged_prefill_quant``) run the same main, sweep and large shapes over
   int8 and fp8 pools quantized per (block, KV head), for float32 and
   bfloat16 queries, against their plain versions (decode after the
   gather) at the same tolerances. Both paged prefill kernels also run
   one large case at jamba's attention shape (dh 128, HQ 32, HKV 8).
   The paged decode kernels run on slot decode's split core
   (``csrc/decode_attention.cu``), the block table resolved per key.
3. timings — per kernel, with CUDA events over back-to-back calls: the
   kernel, its plain version, the one PyTorch library call computing the
   same function (``F.rms_norm``, ``F.scaled_dot_product_attention``; for
   the paged kernels SDPA over the gathered chains, the gather timed
   apart; the port never calls them), and the bound: the larger of bytes
   moved over 3.35 TB/s and operations over the peak for the input type
   (67 TFLOP/s fp32 without tensor cores, 989 TFLOP/s bf16), from the H100
   SXM data sheet, counting the keys this run's data makes live (for the
   quantized kernels at 1 byte per element plus the live blocks' scales;
   their yardstick is SDPA over chains gathered and decoded beforehand,
   the gather and decode timed apart). Also at one larger shape per
   kernel, where the bound is not just launch cost. The plain
   ``quant_insert`` (the quantized write; plain PyTorch in both packages,
   no TPU kernel) is timed per call at path C's pool and at the large
   decode's pool. ``moe_route`` against ``moe_route_ref`` (``route_phase``):
   the MoE path's shapes (N 4 and 32, D 2048, E 64, k 6), kimi-k2's router
   (N 4 and 32, D 7168, E 384, k 8), a sweep (E 1 to 2048, E 100 at decode
   and at prefill, k = E at E 384, a prefill of six expert slices with D
   split), exact-tie cases at E 64 (decode) and E 384 (prefill) and N
   4096, float32 and bfloat16 inputs; gates within 1e-5, indices equal
   except where the plain probabilities tie within 1e-6 (``check_route``
   counts those rows); timed the same way, the library yardstick being
   three calls (matmul, softmax, topk). The decode shapes of both
   kernels also get an L2-cold device time (``cold_device_ms``: 128 MB
   written between launches, the kernel's own time only), the condition
   the engine runs them in.
   ``rwkv_scan`` against ``rwkv_scan_ref`` (``rwkv_scan_phase``): the
   RWKV path's admission (1,32,64,64), a sweep (hd 16 to 512 -- 33 and
   100 take narrow staged copies, 192, 256 and 512 16 and 32 key rows a
   lane; nh 3, S 1, 31 and 70, B 2; 8 columns a lane over 320 heads),
   bfloat16 r, k, v, w with u in bfloat16 or float32, and (4,1024,64,64);
   y and the final state within 1e-4 in both dtypes (both sides widen
   exactly and compute in float32); timed the same way, the admission
   also L2-cold, each device time read both as a sum over the profiler's
   records and as their mean times the launches a call
   (``kernel_device_ms``). No single PyTorch call computes the
   recurrence, so its library time is null. ``mamba_scan`` against
   ``mamba_scan_ref`` (``mamba_scan_phase``): the Mamba path's admission
   (1,32,8192,16), a sweep (tests/test_kernels.py's shapes, S 1, a ragged
   di, B 4 and 8, ds 5, 32, 64, 100, 128 and 256) and (4,1024,8192,16),
   float32 and bfloat16 inputs; y and the final state within 1e-4 / 2e-2;
   timed as ``rwkv_scan``, the exps' SFU time printed beside the bound;
   library time null. The router also runs
   at jamba's shapes (N 4 and 32, D 4096, E 16, k 2).
4. path — the main paths through their entry points, full-width
   tinyllama-1.1b cut to MAIN_BLOCKS (6) of its 22 layers (as in phases
   5-9 and 12: the run stays inside its time limit) with the port's
   seeded init, ``nss_shortcut``, 8
   requests each: slotted ``--load open`` and ``--load seq``; paged path A
   (``--kv paged --shared-prefix-len 16``, open load) and paged path B
   (``--kv paged --chunked --budget 48 --chunk-width 24``, open load);
   the quantized paths C (path A with ``--kv-dtype int8``) and D (path B
   with ``--kv-dtype fp8``). Launch counts are zeroed just before each and
   read just after; every kernel of a path must have launched (and no
   unquantized paged kernel on C and D, nor a quantized one on A and B),
   every request must complete with its budget, and C's and D's blocks
   must be >= 1.9x smaller than A's. Then, the tinyllama phases'
   tensors released, the MoE path: ``run_engine`` on full-width,
   full-depth moonshot-v1-16b-a3b with ``dtype="bf16"`` (56.1 GB of
   parameters), the same traffic; moe_route must launch once per layer of
   every admission and decode microstep, beside rmsnorm, flash and slot
   decode; its peak device memory is printed. Then, the MoE phases'
   tensors released, the RWKV path: ``run_engine`` on full-width,
   full-depth rwkv6-7b in fp32 (32.2 GB of parameters), the same traffic;
   rwkv_scan must launch once per layer of every admission (32) and never
   at decode, rmsnorm must launch, no attention kernel may. Then, the RWKV
   phases' tensors released, the Mamba path: ``run_engine`` on
   full-width jamba-v0.1-52b cut to 1 of its 4 blocks (7 Mamba layers, 1
   attention layer, 4 MoE MLPs; 13.3 B parameters, 53.2 GB in fp32), the
   same traffic; mamba_scan must launch exactly 7 x admissions and never
   at decode, flash once per admission, moe_route once per MoE layer of
   every forward, rmsnorm 17 per forward; no paged kernel.
5. teacher-forced check — prefill, then 8 slotted decode steps (the
   engine's), 8 uniform decode steps (``--load seq``) and 8 paged decode
   steps over a pool filled through a permuted table, each from the same
   prefill, and one paged chunk pass of 24 tokens at position 8; then 8
   paged decode steps over an int8 pool and the chunk pass over an fp8
   pool, where the kernel path also replays the plain path's K/V writes
   (an ulp of difference in K can move a code by a whole quantization
   step); at full width, kernels against plain versions on the card, fed
   the plain path's tokens: max |Δlogit| <= 2e-3. The quantized kernel
   path writing its own K/V, and the quantized plain logits against the
   fp32 control's (the formats' own error), are printed, not gated. The agreement of engine streams (slotted,
   paged, paged chunked) with sequential streams is printed and does not
   gate (greedy streams of a random-init model flip on near-ties). The
   MoE model (``moe_teacher_forced_phase``): prefill, then 8 slotted
   decode steps with float32 activations over its bf16 parameters, the
   kernel path replaying the plain path's routing (``routes``): max
   |dlogit| <= 2e-3. The kernel path routing on its own, its differing
   expert choices, and the bf16-activation run are printed, not gated.
   The RWKV model (``rwkv_teacher_forced_phase``): prefill, then 8
   slotted decode steps, kernel path against plain path, the kernel path
   replaying the plain path's layer inputs (``layer_inputs``): max
   |dlogit| <= 2e-3; the prefill states' max error is printed, and the
   kernel path on its own inputs, not gated, beside the plain path against
   itself with its embedding output moved one ulp: the witness of how far
   the random-init model at full width carries a rounding difference.
   The Mamba model (``mamba_teacher_forced_phase``): prefill, then 8
   slotted decode steps, the kernel path replaying the plain path's
   routing and layer inputs: max |dlogit| <= 2e-3, the prefill's scan and
   conv states compared; the free-running kernel path and the nudged
   plain path printed, not gated.
6. profile — where one engine run's time goes (``profile_phase``), slotted
   and paged chunked, the MoE model's slotted run in bf16, the RWKV
   model's and the Mamba model's in fp32: wall time, device busy time, the
   device's idle share, the top kernels.
7. the serve step's other modes, tinyllama-1.1b at full width in fp32,
   between the tinyllama profile and the router phase: ``prng_phase``
   (threefry keys, ``fold_in``, ``split`` and random bits on CUDA equal to
   the CPU's bit for bit, 64 seeds, rids 0..7, (32000,) and (4, 32000));
   ``modes_phase``: path E (slotted ``--chunked --budget 48
   --chunk-width 24``: rmsnorm and slot decode launch, flash never), path
   T (slotted, temperature 0.8, top-k 40, 4 slots and 1: every request's
   last key equals the CPU key chain) and paths S1-S3 (n-gram speculation
   of width 4 over programs of 4: slotted, paged, paged int8; drafts
   accepted, S2 through ``paged_prefill``, S3 through the fused-dequant
   kernels only), every request finished; ``verify_teacher_forced_phase``
   (the paged verify pass's (B, W, V) logits, kernels vs plain versions,
   within 2e-3 over fp32 and int8 pools); ``modes_profile_phase`` (wall,
   busy, idle share of E, T against greedy, S1-S3). The kernel phase also
   checks and times paged prefill at the verify shape (labels ``verify``;
   device time by ``kernel_device_ms``).
8. the host KV tier, tinyllama-1.1b at full width in fp32, after the
   modes' profile: ``tier_phase`` (paths W1-W7 over 8 open-load requests
   with path A's shared prefix: swap preemption async and ``--sync-swap``
   over a pool of 12 blocks, int8 blocks, chunked with a victim swapped
   mid-prefill, sampled, a warm start from a saved prefix cache, the TTFT
   budget tuner; streams equal to the recompute runs and to paths A / C,
   swaps resumed, bytes accounted by block, no host block left to a
   handle, the host tier pinned, every kernel of each path launched);
   ``tier_transfer_phase`` (swap-out + drain and swap-in of 5- and
   128-block chains, fp32 and int8, device and host time, beside plain
   pinned and pageable copies of the same bytes); ``tier_profile_phase``
   (M1: W1's wall, busy and idle share against recompute under the same
   pool).
9. the fleet, tinyllama-1.1b at full width (MAIN_BLOCKS layers) in fp32,
   after the tier phases (``fleet_phase``): FL1 one replica == path A (and its
   utilization == the bare engine's); FL2 one prefill and one decode cell
   == path A, 8 handoffs, the prefill cell decoding nothing; FL3 FL2 over
   int8 blocks == the colocated chunked int8 engine, blocks 3.98x
   smaller; FL4 two colocated replicas over the shared store == path A,
   publishes and cross-replica hits; FL5 ``run_fleet_engine`` at 4
   replicas (2 prefill cells): 8 handoffs, a Chrome trace with tracks
   engine/0-3 and 8 handoff events, one weight copy, the peak memory
   beside FL1's; each path's kernels launched; the handoff cost, the bare
   engine, 2 colocated replicas and FL2 profiled, and one replica's sync
   against the next replica's program on the one stream. Paths A and C
   come from the path phase.
10. the model zoo's remainder, the last phase (``zoo_phase``): each
   config at its published widths, one at a time, seeded init, depth cut
   where 80 GB or the run's time limit forces it: Z1 qwen2-7b (8 of 28
   layers, fp32, QKV biases drawn nonzero) and Z6 mistral-large-123b (8
   of 88 layers, bf16) through the paged engine as path A; Z2
   h2o-danube-1.8b (8 of 24 layers, fp32) slotted, 2 requests of 4,128 +
   32 and 2 of 32 + 32 (the 4,096-token window rolls at admission and
   binds at decode); Z5 mixtral-8x7b (8 of 32 layers, bf16) and Z7
   kimi-k2-1t-a32b (1 of 61
   layers, bf16) slotted; Z3 llama-3.2-vision-11b (40 layers, fp32, every
   cross-attention gate 1.0) and Z4 musicgen-medium (48 layers, fp32,
   frame embeddings) at model level, as the engine refuses both. Gated:
   every request finished, every kernel of the path launched (flash,
   rmsnorm, slot or paged decode, ``moe_route`` once a layer of every
   forward on Z5 and Z7), the kernel path against the plain path
   teacher-forced (f32 activations, MoE routing replayed) within 2e-3,
   and on Z2 the last decode step past the window against a plain
   4,160-position prefill within 2e-3. Printed: tokens/s, peak memory,
   each engine path's profile. The kernel phase holds flash, slot decode,
   paged decode and paged prefill at the zoo's head shapes (labels
   ``zoo``: HQ/HKV/dh 28/4/128, 96/8/128, 32/8/80, 64/8/112), flash with
   danube's 4,096-token window at S 4,128 and slot decode over its
   4,096-key buffer, and the router at mixtral's rows (E 8, k 2).
11. training, after the zoo (``train_phases``; in the full run its
   backward cases run right after the kernel phase, while the profiler
   still keeps its records, ROADMAP M2): ``flash_attention_bwd``
   against the plain backward (autograd through the plain attention; a
   bf16 case against the same values widened to fp32) at the train
   path's q (4,1024,32,64), qwen2's G 7, kimi's dh 112, danube's 4,096
   window at S 4,128, ragged S 1, 7 and 129, dh 80 with a 100-token
   window at S 333 and dh 112 at S 100, fp32 and bf16, its lse from the
   forward kernel (held against the plain lse, the forward's output
   bit-identical with and without it, a call without lse raising), max
   |d| over the largest |grad| within 1e-4 / 2e-2, two runs
   bit-identical, timed (device time both ways, and by CUDA launch)
   beside the plain backward, SDPA forward + backward, SDPA's backward
   alone (forward + backward less forward) and the bound; every serving
   wrapper raising on a grad-requiring CUDA input (``grad_guard_phase``); TR1 (``train_path_phase``): ``python -m
   repro_torch.launch.train --arch tinyllama-1.1b --preset nss_shortcut``
   through its ``main`` at full width, fp32, 8 steps of 4 x 1,024 tokens
   at lr 1e-3, every step's loss finite and the last below the first,
   flash and its backward 22 launches a step; TR2
   (``train_compare_phase``): the kernel path against the plain path
   over MAIN_BLOCKS (6) layers (step 1's loss, gradient norm and every
   parameter's gradient; 4 steps' losses within 10 x lr), one step and
   one AdamW update profiled; TR3 (``train_recovery_phase``): the
   driver cut to 2 layers, a failure injected at step 6, the losses
   bit-identical to the clean run's. TR1-TR3 each run whatever an earlier one's gate says;
   the phase raises at its end if any failed.
12. serving over a mesh, after the fleet (``mesh_phase``): full-width
   tinyllama-1.1b in fp32 over 1x2 (tensor parallel: HQ 16, HKV 2 a
   rank) and 2x1 (slots over data: 2 slot rows a rank), one spawn
   (``repro_torch.launch.mesh.spawn``) whose two ranks build both
   meshes in turn, on the one card over gloo; the slotted path and paths A and C (C at 1x2 only)
   through ``run_engine`` in every rank; every request finished, every
   kernel of each path launched on every rank, the KV bytes per shard
   halved where the heads or the slot rows split, the streams at both
   meshes equal to the unsharded paths' (1x2's path C, over int8 pools,
   equal or parting only at near ties: ``mesh_phase``), 1x2's
   teacher-forced kernel
   path within 2e-3 of the unsharded kernel path over fp32 pools and
   over int8 pools (each rank replaying its heads of the unsharded
   run's K/V writes). The kernel phase
   holds rows 1-6b at the mesh's local shapes (labels ``mesh``). Two
   ranks sharing a card measure correctness, not tensor-parallel speed.
12b. the zoo over a mesh, after the serving mesh (``mesh_zoo_phase``;
   ROADMAP entry 9c): moonshot-v1-16b-a3b (MZ1, 2 of 48 layers: bf16
   slotted, fp32 path A), jamba-v0.1-52b (MZ2, the first 5
   layers of its block, fp32) and rwkv6-7b (MZ3, 8 of 32 layers, fp32)
   at published widths over 1x2, their experts, Mamba channels and RWKV
   heads split over "model", each rank building its weights in turn;
   every request finished, every kernel launched on every rank and the
   model's own (moe_route, mamba_scan, rwkv_scan) as often as unsharded,
   the streams equal to the unsharded paths' (slotted: or parting only
   at near ties, within twice 2e-3 in fp32 and twice bf16's own
   |dlogit| from f32 in bf16), the teacher-forced kernel path (the
   unsharded run's routing replayed) within 2e-3; MZT: moonshot training (2
   layers) at 1x2 and at 2x1 with ``ep_resident`` against the unsharded
   kernel path (TR2's tolerances); FLM: the fleet launcher's rank entry
   at 1x2, 2 replicas, the unsharded fleet's streams. The kernel rows at
   a rank's local shapes carry labels ``mesh zoo``.
13. training over a mesh, the last phase (``mesh_train_phase``):
   full-width tinyllama-1.1b in fp32, TR1's data, the ranks of both
   meshes at once on the one card over gloo. MT1:
   ``build_sharded_train_step`` at 2x1 (FSDP, 2 of the 4 sequences a
   rank) and 1x2 (Megatron, HQ 16, HKV 2 a rank) over MT_LAYERS (4)
   layers against the unsharded kernel path from one seed (TR2's
   tolerances: step 1's loss, gradient norm and every piece's gradient;
   3 steps' losses within 10 x lr), flash and its backward 4 launches a
   rank a step, rmsnorm 9, the last step profiled; MT3: the launcher's
   rank entry (what ``--data-mesh 2`` runs in each rank) in the 2x1
   ranks at 2 layers, a failure at step 3 replayed from the step-2
   checkpoint, every rank's final state equal to the clean run's
   (sha256); MT2: the clean run's step-2 checkpoint (saved at 2x1,
   gathered, rank 0 writing) restored onto 1x2 and one device bit for
   bit, 1x2 training on from it within 10 x lr of 2x1. The kernel phase
   and the backward's cases hold rmsnorm, flash and its backward at the
   training mesh's local shapes (labels ``mesh train``). Logged: a
   rank's seconds a step, device busy, peak memory and bytes to each
   kind of collective.

Kernel times: ``ms`` is CUDA-event time per call over back-to-back calls
(at the main path's small shapes that is the host's launch cost);
``device_ms`` is the kernels' own device time under ``torch.profiler``.

The last two lines are the card's name and power limit (``nvidia-smi``)
then ``{"ok": true, "device": {...}}``; the line before them is the
per-kernel JSON record. Exits non-zero without a GPU.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BPS = 3.35e12                       # H100 SXM HBM3
PEAK_OPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}

# the main path: full-width tinyllama-1.1b, 4 slots, prompt 32, gen 32;
# its serving phases (paths, modes, tier, fleet, mesh) and TR2 cut it to
# MAIN_BLOCKS of its 22 layers so that the whole run stays well inside its
# time limit (each engine run's host time grows with the depth)
ARCH, PRESET = "tinyllama-1.1b", "nss_shortcut"
MAIN_BLOCKS = 6
# the MoE path: full-width moonshot-v1-16b-a3b in bf16, the same traffic
MOE_ARCH = "moonshot-v1-16b-a3b"
# the RWKV path: full-width rwkv6-7b in fp32, the same traffic
RWKV_ARCH = "rwkv6-7b"
# the Mamba path: full-width jamba-v0.1-52b cut to 1 of its 4 blocks, fp32,
# the same traffic
MAMBA_ARCH, MAMBA_BLOCKS = "jamba-v0.1-52b", 1
SLOTS, PROMPT, GEN, REQUESTS = 4, 32, 32, 8
MAX_LEN = PROMPT + GEN + 8
# the paged paths: blocks of 16 (5 per slot at max_len 72), a 16-token
# shared prefix (path A), budget 48 and chunks of 24 (path B)
BS, SHARED, BUDGET, CHUNK_W = 16, 16, 48, 24
NB = -(-MAX_LEN // BS)
# the serve step's other modes (paths E, T, S1-S3): sampling at
# temperature 0.8 and top-k 40 from seed 7 (path T); n-gram speculation of
# width 4 over programs of 4 decode steps, on prompts tiling an 8-token
# core (paths S1-S3); the verify pass's kernel case (row 5v)
TEMP, TOP_K, SAMPLE_SEED = 0.8, 40, 7
SPEC_W, SPEC_K, SPEC_CORE = 4, 4, 8
# the host tier's paths W1-W3 and W5: a pool of 12 blocks, so four slots
# of four blocks must preempt; W4 (chunked) 10: the chunked engine takes
# prompt blocks chunk by chunk, and 12 hold its schedule without a swap
TIER_BLOCKS, TIER_CHUNK_BLOCKS = 12, 10
VERIFY_STARTS = (33, 47, 60, 18)
VERIFY_LABEL = "verify: paged prefill q (4,4,32,64) starts (33,47,60,18)"


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def main_config():
    """The main path's config: full-width tinyllama-1.1b, MAIN_BLOCKS
    layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), num_blocks=MAIN_BLOCKS)


def cuda_ms(fn, iters: int = 200, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof) -> dict:
    """The profiler's raw CUDA records by name: {name: (records, device
    us)}, what ``key_averages`` gives for device events without building
    its event tree (minutes at an engine run's records)."""
    import torch
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, us = by.get(e.name(), (0, 0.0))
            by[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return by


def _profiled(fn, iters: int, between=None):
    """The CUDA kernels' records of ``iters`` calls of ``fn`` (after one
    warm call) under ``torch.profiler`` (CUPTI), and the launches the
    port's wrappers counted over those calls. ``between`` runs before
    each call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    fn()
    torch.cuda.synchronize()
    before = dict(_build.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    made = {k: n - before.get(k, 0) for k, n in _build.launches.items()}
    return _device_events(prof), made


def device_ms(fn, iters: int = 50, between=None, only: str = ""):
    """Device time per call: the CUDA kernels' own time under
    ``torch.profiler`` (CUPTI), summed and divided by the call count —
    free of the host launch cost that the event timing of back-to-back
    calls includes. ``between`` runs before each call (the L2 flush of
    ``cold_device_ms``); ``only`` keeps the kernels whose name holds it.
    None when the profiler records no device time. A record the profiler
    drops lowers it (ROADMAP M2): ``kernel_device_ms`` reads a
    hand-written kernel both ways."""
    events, _ = _profiled(fn, iters, between)
    total = sum(us for name, (_, us) in events.items() if only in name)
    return total / iters / 1e3 if total > 0 else None


def kernel_device_ms(fn, kernel: str, iters: int = 50, between=None,
                     symbol: str = "", cuda_launches: int = 1,
                     tries: int = 3, parts=()):
    """The device time per call of the hand-written kernel ``kernel``
    (its CUDA records are those whose name holds ``symbol``, by default
    ``kernel``: the fused-dequant paged prefill counts as
    ``paged_prefill_quant`` and runs ``paged_prefill_kernel``), read two
    ways from
    one profiled loop: as ``device_ms`` (the records summed over the calls
    made), and as the records' mean times the CUDA launches a call (the
    launches its wrapper counted, ``_build.launches``, times
    ``cuda_launches``, the CUDA launches one counted launch makes: the
    flash backward's 2 or 3), which a record the profiler drops does not
    lower (ROADMAP M2). A loop whose records fall short of its launches
    is profiled again, up to ``tries`` times, and the one that kept most
    is read. (None, None) when no record was kept; raises when the
    wrapper counted no whole number of launches a call or the records
    outnumber the launches. Given ``parts`` (substrings of the CUDA
    kernels' names), also their device ms a call from the same records,
    as a third value."""
    best = None
    for _ in range(tries):
        events, made = _profiled(fn, iters, between)
        per_call, rest = divmod(made.get(kernel, 0), iters)
        per_call *= cuda_launches
        records = [v for name, v in events.items()
                   if (symbol or kernel) in name]
        kept = sum(n for n, _ in records)
        if per_call < 1 or rest or kept > per_call * iters:
            raise AssertionError(f"{kernel}: {made.get(kernel, 0)} counted "
                                 f"launches and {kept} records over "
                                 f"{iters} calls")
        if best is None or kept > best[0]:
            best = (kept, records, events)
        if kept == per_call * iters:
            break
    kept, records, events = best
    total = sum(us for _, us in records)
    by = {p: sum(us for name, (_, us) in events.items() if p in name)
          / iters / 1e3 for p in parts}
    read = ((None, None) if not kept or total <= 0 else
            (total / iters / 1e3, total / kept * per_call / 1e3))
    return (*read, by) if parts else read


#: bytes written between launches for an L2-cold time: more than the
#: H100's 50 MB of L2
FLUSH_BYTES = 128 * 2 ** 20


def l2_flush():
    """A call that writes FLUSH_BYTES on the card (``between`` for an
    L2-cold device time)."""
    import torch
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: flush.fill_(1.0)


def cold_device_ms(fn, kernel: str, iters: int = 50):
    """The device time of the kernels named ``kernel`` with L2 cold, as the
    engine runs a decode step's kernels between layers: FLUSH_BYTES are
    written before each call, and only ``kernel``'s own time counts."""
    return device_ms(fn, iters, between=l2_flush(), only=kernel)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, n_ops: float, dtype) -> tuple:
    t_mem = n_bytes / MEM_BPS * 1e3
    t_ops = n_ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def rwkv_scan_ops(B, S, nh, hd) -> float:
    """The RWKV-6 recurrence's operations: 5 hd^2 + 5 hd a token and
    head."""
    return B * S * nh * (5.0 * hd * hd + 5.0 * hd)


def mamba_scan_ops(B, S, di, ds) -> float:
    """The selective scan's operations: 7 a (token, channel, state), plus
    dt·x a (token, channel)."""
    return 7.0 * B * S * di * ds + B * S * di


def check_close(name, got, want, dtype) -> float:
    import torch
    tol = TOL[str(dtype)]
    err = (got.float() - want.float()).abs()
    lim = tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or (err > lim).any():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max |err| {err.max().item():.3e}, "
                             f"tolerance {tol})")
    return err.max().item()


# ---------------------------------------------------------------------------
# kernels: inputs, plain versions, library yardsticks, bounds
# ---------------------------------------------------------------------------

def make_cases(gen, dtype):
    """Kernel cases: (kernel, label, call, plain, library, bytes, ops[,
    gather]). ``gather`` builds the library call's input where the library
    needs a view the kernel never builds (the paged kernels' gathered
    chains); it is timed apart from the library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import kv_quant, ops, ref
    from repro_torch.kernels import paged_decode as kpd
    from repro_torch.kernels import paged_prefill as kpp
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import slot_decode as ksd

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    cases = []

    def rms_case(label, shape, scale_dtype=torch.float32):
        x = rn(*shape)
        s = (torch.randn(shape[-1], generator=gen, device="cuda") * 0.1
             + 1.0).to(scale_dtype)
        s_lib = s.to(dtype)
        cases.append(("rmsnorm", label, lambda: krms.rmsnorm(x, s),
                      lambda: ref.rmsnorm_ref(x, s),
                      lambda: F.rms_norm(x, (shape[-1],), s_lib, 1e-5),
                      nbytes(x, s, x), 4.0 * x.numel()))

    def flash_case(label, B, S, HQ, HKV, dh, window=0, causal=True):
        q, k, v = rn(B, S, HQ, dh), rn(B, S, HKV, dh), rn(B, S, HKV, dh)
        i = torch.arange(S, device="cuda")
        live = i[:, None] >= i[None, :] if causal else torch.ones(
            S, S, dtype=torch.bool, device="cuda")
        if window:
            live &= i[:, None] - i[None, :] < window
        pairs = int(live.sum().item()) * B * HQ
        qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
        lib_mask = live if window or not causal else None
        cases.append((
            "flash_attention", label,
            lambda: kfa.flash_attention(q, k, v, causal=causal,
                                        window=window),
            lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window),
            lambda: F.scaled_dot_product_attention(
                qT, kT, vT, attn_mask=lib_mask, is_causal=lib_mask is None,
                enable_gqa=True),
            nbytes(q, k, v, q), 4.0 * dh * pairs))

    def splits(label, B, T, HKV):
        return f"{label} [nsplit {ksd.num_splits(B, HKV, T)}]"

    def slot_case(label, B, T, HQ, HKV, dh, lives):
        q, k, v = rn(B, HQ, dh), rn(B, T, HKV, dh), rn(B, T, HKV, dh)
        valid = torch.zeros(B, T, dtype=torch.bool, device="cuda")
        for b, n in enumerate(lives):
            valid[b, :n] = True
        keys = int(valid.sum().item())           # live keys, this run's data
        kT, vT = k.transpose(1, 2), v.transpose(1, 2)
        cases.append((
            "slot_decode", splits(label, B, T, HKV),
            lambda: ksd.slot_decode_attention(q, k, v, valid),
            lambda: ref.slot_decode_attention_ref(q, k, v, valid),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kT, vT, attn_mask=valid[:, None, None],
                enable_gqa=True),
            nbytes(q, valid, q) + 2 * keys * HKV * dh * k.element_size(),
            4.0 * dh * HQ * keys))

    def uniform_case(label, B, T, HQ, HKV, dh, pos, filled, window=0):
        """The uniform wrapper (``--load seq``): ``ops.decode_attention``
        builds the shared (T,) mask from slot_pos/pos and broadcasts it to
        the slot kernel as a stride-0 (B,T) view. The plain version gets a
        mask built here, independently: entries 0..filled-1 hold their
        position, the rest are empty (-1); live are those <= pos and, with
        a window, > pos - window."""
        q, k, v = rn(B, HQ, dh), rn(B, T, HKV, dh), rn(B, T, HKV, dh)
        i = torch.arange(T, device="cuda")
        slot_pos = torch.where(i < filled, i, -1).to(torch.int32)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        valid = (i < filled) & (i <= pos)
        if window:
            valid &= i > pos - window
        keys = int(valid.sum().item()) * B
        kT, vT = k.transpose(1, 2), v.transpose(1, 2)
        cases.append((
            "slot_decode", splits(label, B, T, HKV),
            lambda: ops.decode_attention(q[:, None], k, v, slot_pos, pos_t,
                                         window=window)[:, 0],
            lambda: ref.decode_attention_ref(q, k, v, valid),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kT, vT, attn_mask=valid[None, None, None],
                enable_gqa=True),
            nbytes(q, slot_pos, q) + 2 * keys * HKV * dh * k.element_size(),
            4.0 * dh * HQ * keys))

    def pool_case(B, nb, bs, HKV, dh, spare, keys):
        """Pools (P+1, bs, HKV, dh) with P = B*nb + spare and row P the
        trash block, and (B, nb) tables: a random permutation of the pool
        rows for each slot's first ceil(keys[b] / bs) blocks (so chains are
        not contiguous), the trash row for the rest."""
        P = B * nb + spare
        kp, vp = rn(P + 1, bs, HKV, dh), rn(P + 1, bs, HKV, dh)
        perm = torch.randperm(P, generator=torch.Generator().manual_seed(P))
        tables = torch.full((B, nb), P, dtype=torch.int32)
        for b, n in enumerate(keys):
            used = -(-n // bs)
            tables[b, :used] = perm[b * nb:b * nb + used].to(torch.int32)
        return kp, vp, tables.cuda()

    def gathered(kp, vp, tables):
        """The library yardstick's input: each slot's logical view,
        (B, HKV, nb*bs, dh), gathered by one indexing call per pool."""
        def g(p):
            B, nb = tables.shape
            return p[tables.long()].reshape(B, nb * p.shape[1], *p.shape[2:]
                                            ).transpose(1, 2).contiguous()
        return g(kp), g(vp)

    def dead_rows(P1, bs, tables, lens):
        """(P+1, bs) bool: the pool positions holding no live key of any
        chain — the trash row, spare blocks and each chain's stale tail."""
        dead = torch.ones(P1, bs, dtype=torch.bool)
        tab = tables.cpu()
        for b, n in enumerate(lens):
            for i in range(-(-n // bs)):
                dead[tab[b, i], :min(bs, n - i * bs)] = False
        return dead.cuda()

    def poisoned(pool, dead, fill):
        """``pool`` with its dead positions set to ``fill`` (NaN, or a code
        byte for a quantized pool: 0x7f is NaN in e4m3), and a copy with
        them zeroed: the kernel reads the first, its plain version the
        second, so a kernel that read a dead row would disagree."""
        out = []
        for v in (fill, 0):
            p = pool.clone()
            kv_quant.raw(p).masked_fill_(dead[:, :, None, None], v)
            out.append(p)
        return out

    def paged_decode_case(label, B, nb, bs, HQ, HKV, dh, pos, spare=1,
                          nan=False):
        kp, vp, tables = pool_case(B, nb, bs, HKV, dh, spare,
                                   [p + 1 for p in pos])
        q = rn(B, HQ, dh)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        valid = torch.arange(nb * bs, device="cuda")[None] <= pos_t[:, None]
        keys = sum(p + 1 for p in pos)           # live keys, this run's data
        kk, vk = kp, vp
        if nan:
            dead = dead_rows(kp.shape[0], bs, tables, [p + 1 for p in pos])
            (kk, kp), (vk, vp) = (poisoned(kp, dead, float("nan")),
                                  poisoned(vp, dead, float("nan")))
        kg, vg = gathered(kp, vp, tables)
        cases.append((
            "paged_decode", splits(label, B, nb * bs, HKV),
            lambda: kpd.paged_decode_attention(q, kk, vk, tables, valid),
            lambda: ref.paged_decode_attention_ref(q, kp, vp, tables, valid),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=valid[:, None, None],
                enable_gqa=True),
            nbytes(q, tables, valid, q) + 2 * keys * HKV * dh
            * kp.element_size(), 4.0 * dh * HQ * keys,
            lambda: gathered(kp, vp, tables)))

    def paged_prefill_case(label, B, W, nb, bs, HQ, HKV, dh, starts,
                           spare=1):
        T = nb * bs
        kp, vp, tables = pool_case(B, nb, bs, HKV, dh, spare,
                                   [min(s + W, T) for s in starts])
        q = rn(B, W, HQ, dh)
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        qpos = start[:, None] + torch.arange(W, device="cuda")[None]
        live = torch.arange(T, device="cuda")[None, None] <= qpos[:, :, None]
        pairs = int(live.sum().item()) * HQ
        keys = sum(min(s + W, T) for s in starts)
        kg, vg = gathered(kp, vp, tables)
        cases.append((
            "paged_prefill", label,
            lambda: kpp.paged_prefill_attention(q, kp, vp, tables, start),
            lambda: ref.paged_prefill_attention_ref(q, kp, vp, tables, start),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kg, vg, attn_mask=live[:, None],
                enable_gqa=True),
            nbytes(q, tables, start, q) + 2 * keys * HKV * dh
            * kp.element_size(), 4.0 * dh * pairs,
            lambda: gathered(kp, vp, tables)))

    def prefill_is_decode_case(label, B, nb, bs, HQ, HKV, dh, pos):
        """paged_prefill at W = 1 against paged_decode at pos = start, on
        the same pools and tables (the 'plain' side is the decode kernel)."""
        kp, vp, tables = pool_case(B, nb, bs, HKV, dh, 1,
                                   [p + 1 for p in pos])
        q = rn(B, HQ, dh)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        valid = torch.arange(nb * bs, device="cuda")[None] <= pos_t[:, None]
        cases.append((
            "paged_prefill", label,
            lambda: kpp.paged_prefill_attention(q[:, None], kp, vp, tables,
                                                pos_t)[:, 0],
            lambda: kpd.paged_decode_attention(q, kp, vp, tables, valid),
            None, 0, 0.0, None))

    def quantized(kp, vp, kvd):
        """The pools' int8 / fp8 codes and per-(block, KV head) scales, as
        the engine's write path encodes them."""
        store = kv_quant.storage_dtype(kvd, torch.float32)
        out = []
        for p in (kp, vp):
            s = kv_quant.block_scales(p.float().abs().amax(dim=(1, 3)), store)
            out += [kv_quant.quantize(p.float(), s[:, None, :, None], store), s]
        return out

    def decoded(kq, ks, vq, vs, tables):
        """The quantized yardstick's input: each slot's logical view
        gathered and decoded to q's dtype, (B, HKV, nb*bs, dh)."""
        def g(p, sc):
            return ref.gather_pool(p, tables, sc).to(dtype).transpose(
                1, 2).contiguous()
        return g(kq, ks), g(vq, vs)

    def live_blocks(lens, bs):
        return sum(-(-n // bs) for n in lens)

    def paged_decode_quant_case(label, kvd, B, nb, bs, HQ, HKV, dh, pos,
                                spare=1, nan=False):
        kp, vp, tables = pool_case(B, nb, bs, HKV, dh, spare,
                                   [p + 1 for p in pos])
        kq, ks, vq, vs = quantized(kp, vp, kvd)
        q = rn(B, HQ, dh)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        valid = torch.arange(nb * bs, device="cuda")[None] <= pos_t[:, None]
        lens = [p + 1 for p in pos]
        keys = sum(lens)
        kk, ksk, vk, vsk = kq, ks, vq, vs
        if nan:
            # dead codes 0x7f, and NaN scales on blocks with no live key
            dead = dead_rows(kp.shape[0], bs, tables, lens)
            idle = dead.all(1)[:, None]
            (kk, kq), (vk, vq) = poisoned(kq, dead, 0x7F), poisoned(vq, dead,
                                                                 0x7F)
            ksk, vsk = (s.masked_fill(idle, float("nan")) for s in (ks, vs))
            ks, vs = (s.masked_fill(idle, 0.0) for s in (ks, vs))
        kg, vg = decoded(kq, ks, vq, vs, tables)
        cases.append((
            "paged_decode_quant", f"{splits(label, B, nb * bs, HKV)} {kvd}",
            lambda: kpd.paged_decode_attention(q, kk, vk, tables, valid, ksk,
                                               vsk),
            lambda: ref.paged_decode_attention_ref(q, kq, vq, tables, valid,
                                                   ks=ks, vs=vs),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=valid[:, None, None],
                enable_gqa=True),
            nbytes(q, tables, valid, q) + 2 * keys * HKV * dh
            + 2 * live_blocks(lens, bs) * HKV * 4, 4.0 * dh * HQ * keys,
            lambda: decoded(kq, ks, vq, vs, tables)))

    def paged_prefill_quant_case(label, kvd, B, W, nb, bs, HQ, HKV, dh,
                                 starts, spare=1):
        T = nb * bs
        lens = [min(s + W, T) for s in starts]
        kp, vp, tables = pool_case(B, nb, bs, HKV, dh, spare, lens)
        kq, ks, vq, vs = quantized(kp, vp, kvd)
        q = rn(B, W, HQ, dh)
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        qpos = start[:, None] + torch.arange(W, device="cuda")[None]
        live = torch.arange(T, device="cuda")[None, None] <= qpos[:, :, None]
        pairs = int(live.sum().item()) * HQ
        kg, vg = decoded(kq, ks, vq, vs, tables)
        cases.append((
            "paged_prefill_quant", f"{label} {kvd}",
            lambda: kpp.paged_prefill_attention(q, kq, vq, tables, start, ks,
                                                vs),
            lambda: ref.paged_prefill_attention_ref(q, kq, vq, tables, start,
                                                    ks=ks, vs=vs),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kg, vg, attn_mask=live[:, None],
                enable_gqa=True),
            nbytes(q, tables, start, q) + 2 * sum(lens) * HKV * dh
            + 2 * live_blocks(lens, bs) * HKV * 4, 4.0 * dh * pairs,
            lambda: decoded(kq, ks, vq, vs, tables)))

    def prefill_is_decode_quant_case(label, kvd, B, nb, bs, HQ, HKV, dh, pos):
        """The quantized kernels: paged_prefill at W = 1 against
        paged_decode at pos = start on the same codes and scales."""
        kp, vp, tables = pool_case(B, nb, bs, HKV, dh, 1,
                                   [p + 1 for p in pos])
        kq, ks, vq, vs = quantized(kp, vp, kvd)
        q = rn(B, HQ, dh)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        valid = torch.arange(nb * bs, device="cuda")[None] <= pos_t[:, None]
        cases.append((
            "paged_prefill_quant", f"{label} {kvd}",
            lambda: kpp.paged_prefill_attention(q[:, None], kq, vq, tables,
                                                pos_t, ks, vs)[:, 0],
            lambda: kpd.paged_decode_attention(q, kq, vq, tables, valid, ks,
                                               vs),
            None, 0, 0.0, None))

    # main-path shapes first (the first case of each kernel is its record)
    rms_case("main: decode rows (4,1,2048)", (SLOTS, 1, 2048))
    rms_case("main: prefill rows (1,32,2048)", (1, PROMPT, 2048))
    flash_case("main: prefill q (1,32,32,64)", 1, PROMPT, 32, 4, 64)
    slot_case("main: decode q (4,32,64) kv (4,72,4,64)", SLOTS, MAX_LEN, 32,
              4, 64, (PROMPT + 1, PROMPT + 17, PROMPT + 32, 5))
    uniform_case("main seq: decode_attention q (1,32,64) kv (1,72,4,64)", 1,
                 MAX_LEN, 32, 4, 64, pos=PROMPT + 17, filled=PROMPT + 20)
    # path A's decode: 4 slots x 5 blocks of 16 + 1 spare + the trash row
    paged_decode_case("main: paged decode q (4,32,64) pools (22,16,4,64)",
                      SLOTS, NB, BS, 32, 4, 64, (32, 48, 71, 0))
    # path B's chunk pass: chunks of 24 starting mid-block
    paged_prefill_case("main: paged prefill q (4,24,32,64) starts "
                       "(0,8,24,40)", SLOTS, CHUNK_W, NB, BS, 32, 4, 64,
                       (0, 8, 24, 40))
    # paths C and D: the same shapes over int8 and fp8 pools
    for kvd in ("int8", "fp8"):
        paged_decode_quant_case("main: paged decode q (4,32,64) pools "
                                "(22,16,4,64)", kvd, SLOTS, NB, BS, 32, 4,
                                64, (32, 48, 71, 0))
        paged_prefill_quant_case("main: paged prefill q (4,24,32,64) starts "
                                 "(0,8,24,40)", kvd, SLOTS, CHUNK_W, NB, BS,
                                 32, 4, 64, (0, 8, 24, 40))
    # the paged verify pass (paths S2 and S3), after every main case (the
    # first case of a kernel is its record): W = 4 (a committed token and
    # up to 3 drafts) a row at decode positions, over path B's pools
    paged_prefill_case(VERIFY_LABEL, SLOTS, SPEC_W, NB, BS, 32, 4, 64,
                       VERIFY_STARTS)
    paged_prefill_quant_case(VERIFY_LABEL, "int8", SLOTS, SPEC_W, NB, BS, 32,
                             4, 64, VERIFY_STARTS)
    # the mesh phase's local shapes (tensor parallelism over 2 ranks: HQ
    # 16, HKV 2 a rank; slots over 2 data ranks: 2 slots a rank)
    rms_case("mesh: decode rows (4,1,2048)", (SLOTS, 1, 2048))
    flash_case("mesh 1x2: prefill q (1,32,16,64) HKV=2", 1, PROMPT, 16, 2,
               64)
    slot_case("mesh 1x2: decode q (4,16,64) kv (4,72,2,64)", SLOTS, MAX_LEN,
              16, 2, 64, (PROMPT + 1, PROMPT + 17, PROMPT + 32, 5))
    slot_case("mesh 2x1: decode q (2,32,64) kv (2,72,4,64)", 2, MAX_LEN, 32,
              4, 64, (PROMPT + 1, PROMPT + 17))
    paged_decode_case("mesh 1x2: paged decode q (4,16,64) pools "
                      "(22,16,2,64)", SLOTS, NB, BS, 16, 2, 64,
                      (32, 48, 71, 0))
    paged_prefill_case("mesh 1x2: paged prefill q (4,24,16,64) starts "
                       "(0,8,24,40)", SLOTS, CHUNK_W, NB, BS, 16, 2, 64,
                       (0, 8, 24, 40))
    # the training mesh's local shapes: 2 of the 4 sequences a rank at
    # 2x1, HQ 16 and HKV 2 a rank at 1x2 (rows replicated over "model")
    rms_case("mesh train 2x1: rows (2,1024,2048)", (2, 1024, 2048))
    flash_case("mesh train 2x1: q (2,1024,32,64) HKV=4", 2, 1024, 32, 4, 64)
    flash_case("mesh train 1x2: q (4,1024,16,64) HKV=2", 4, 1024, 16, 2, 64)
    for kvd in ("int8", "fp8"):
        paged_decode_quant_case("mesh 1x2: paged decode q (4,16,64) pools "
                                "(22,16,2,64)", kvd, SLOTS, NB, BS, 16, 2,
                                64, (32, 48, 71, 0))
        paged_prefill_quant_case("mesh 1x2: paged prefill q (4,24,16,64) "
                                 "starts (0,8,24,40)", kvd, SLOTS, CHUNK_W,
                                 NB, BS, 16, 2, 64, (0, 8, 24, 40))
    # the MoE path's shapes: moonshot-v1-16b-a3b, D 2048, HQ = HKV = 16,
    # dh 128 (G = 1), the same slots, prompt and cache length; the norm
    # scales in bf16, as all of its parameters
    rms_case("moe: decode rows (4,1,2048)", (SLOTS, 1, 2048), torch.bfloat16)
    rms_case("moe: prefill rows (1,32,2048)", (1, PROMPT, 2048),
             torch.bfloat16)
    flash_case("moe: prefill q (1,32,16,128)", 1, PROMPT, 16, 16, 128)
    slot_case("moe: decode q (4,16,128) kv (4,72,16,128)", SLOTS, MAX_LEN,
              16, 16, 128, (PROMPT + 1, PROMPT + 17, PROMPT + 32, 5))
    # the Mamba path's shapes: jamba-v0.1-52b, D 4096, HQ 32, HKV 8, dh 128
    # (G = 4), fp32 parameters (the first fp32 dh-128 G-4 runs in a path)
    rms_case("jamba: decode rows (4,1,4096)", (SLOTS, 1, 4096))
    rms_case("jamba: prefill rows (1,32,4096)", (1, PROMPT, 4096))
    flash_case("jamba: prefill q (1,32,32,128)", 1, PROMPT, 32, 8, 128)
    slot_case("jamba: decode q (4,32,128) kv (4,72,8,128)", SLOTS, MAX_LEN,
              32, 8, 128, (PROMPT + 1, PROMPT + 17, PROMPT + 32, 5))
    # sweep
    rms_case("sweep (3,40,96)", (3, 40, 96))
    rms_case("sweep odd D (5,7,33)", (5, 7, 33))
    flash_case("sweep HKV=3 dh=80 S=100", 2, 100, 6, 3, 80)
    flash_case("sweep odd dh=33 window=16 S=77", 1, 77, 4, 2, 33, window=16)
    flash_case("sweep MQA dh=128 window=40 S=130", 1, 130, 4, 1, 128,
               window=40)
    flash_case("sweep non-causal dh=256 S=64", 2, 64, 8, 8, 256,
               causal=False)
    slot_case("sweep HKV=3 T=24", 2, 24, 6, 3, 64, (24, 7))
    slot_case("sweep odd dh=129 MQA", 2, 32, 4, 1, 129, (31, 16))
    slot_case("sweep empty row T=40", 2, 40, 8, 2, 80, (33, 0))
    # split over T with a combine pass (2 splits): odd dh (element copies
    # in bf16, 4-byte copies in fp32), HKV 3, a split with no valid key
    slot_case("sweep split HKV=3 odd dh=33 T=700", 2, 700, 6, 3, 33,
              (700, 333))
    uniform_case("sweep decode_attention HKV=3 window=16 T=40", 3, 40, 6, 3,
                 33, pos=30, filled=35, window=16)
    paged_decode_case("sweep paged decode HKV=3 dh=33 bs=8", 3, 4, 8, 6, 3,
                      33, (0, 13, 31))
    paged_decode_case("sweep paged decode MQA dh=129 bs=16", 2, 3, 16, 4, 1,
                      129, (47, 16), spare=3)
    # blocks that line up with no key tile (bs 24 against tiles of 32 and
    # 64 keys); four splits, two of them with no valid key; NaN in the
    # trash row, the spare blocks and the chains' stale tails
    paged_decode_case("sweep paged decode bs=24 HKV=3", 3, 3, 24, 6, 3, 64,
                      (5, 30, 71))
    paged_decode_case("sweep paged decode 4 splits MQA bs=8", 1, 128, 8, 4,
                      1, 64, (300,))
    paged_decode_case("sweep paged decode NaN trash and tails bs=16", 3, 4,
                      16, 8, 2, 64, (0, 21, 50), spare=2, nan=True)
    paged_prefill_case("sweep paged prefill HKV=3 dh=33 bs=8 W=7", 3, 7, 4,
                       8, 6, 3, 33, (0, 5, 25))
    paged_prefill_case("sweep paged prefill dh=129 bs=16 W=1", 2, 1, 3, 16,
                       4, 1, 129, (0, 40))
    paged_prefill_case("sweep paged prefill W at a block boundary bs=8 W=8",
                       2, 8, 4, 8, 6, 3, 64, (8, 16))
    # every copy width of the prefill kernel's staging: dh 36 copies 16
    # bytes at a time in fp32, 8 in bf16, 4 in int8/fp8; dh 256 fills the
    # widest tile exactly
    paged_prefill_case("sweep paged prefill dh=36 bs=8 W=5", 2, 5, 4, 8, 4,
                       2, 36, (3, 20))
    paged_prefill_case("sweep paged prefill dh=256 bs=8 W=5", 2, 5, 3, 8, 4,
                       2, 256, (0, 11))
    prefill_is_decode_case("sweep paged prefill W=1 == paged decode HKV=3 "
                           "dh=33 bs=8", 3, 4, 8, 6, 3, 33, (0, 13, 31))
    prefill_is_decode_case("sweep paged prefill W=1 == paged decode dh=129 "
                           "bs=16", 2, 3, 16, 8, 2, 129, (47, 5))
    for kvd in ("int8", "fp8"):
        paged_decode_quant_case("sweep paged decode HKV=3 dh=33 bs=8", kvd,
                                3, 4, 8, 6, 3, 33, (0, 13, 31))
        paged_decode_quant_case("sweep paged decode MQA dh=129 bs=16", kvd,
                                2, 3, 16, 4, 1, 129, (47, 16), spare=3)
        paged_decode_quant_case("sweep paged decode bs=24 HKV=3", kvd, 3, 3,
                                24, 6, 3, 64, (5, 30, 71))
        paged_decode_quant_case("sweep paged decode 4 splits MQA bs=8", kvd,
                                1, 128, 8, 4, 1, 64, (300,))
        paged_decode_quant_case("sweep paged decode NaN trash and tails "
                                "bs=16", kvd, 3, 4, 16, 8, 2, 64,
                                (0, 21, 50), spare=2, nan=True)
        paged_prefill_quant_case("sweep paged prefill HKV=3 dh=33 bs=8 W=7",
                                 kvd, 3, 7, 4, 8, 6, 3, 33, (0, 5, 25))
        paged_prefill_quant_case("sweep paged prefill dh=129 bs=16 W=1", kvd,
                                 2, 1, 3, 16, 4, 1, 129, (0, 40))
        paged_prefill_quant_case("sweep paged prefill W at a block boundary "
                                 "bs=8 W=8", kvd, 2, 8, 4, 8, 6, 3, 64,
                                 (8, 16))
        paged_prefill_quant_case("sweep paged prefill dh=36 bs=8 W=5", kvd,
                                 2, 5, 4, 8, 4, 2, 36, (3, 20))
        paged_prefill_quant_case("sweep paged prefill dh=256 bs=8 W=5", kvd,
                                 2, 5, 3, 8, 4, 2, 256, (0, 11))
        prefill_is_decode_quant_case("sweep paged prefill W=1 == paged "
                                     "decode HKV=3 dh=33 bs=8", kvd, 3, 4, 8,
                                     6, 3, 33, (0, 13, 31))
        prefill_is_decode_quant_case("sweep paged prefill W=1 == paged "
                                     "decode dh=129 bs=16", kvd, 2, 3, 16, 8,
                                     2, 129, (47, 5))
    # decode rows at kimi-k2's and mistral-large's widths: several warps a
    # row
    rms_case("wide: decode rows (4,1,7168)", (SLOTS, 1, 7168))
    rms_case("wide: decode rows (4,1,12288)", (SLOTS, 1, 12288))
    # larger shapes, where the bound is more than launch cost; (16384,
    # 4096) reads and writes more than the 50 MB L2 holds
    rms_case("large (4096,2048)", (4096, 2048))
    rms_case("large (4096,2048) bf16 scale", (4096, 2048), torch.bfloat16)
    rms_case("large past L2 (16384,4096)", (16384, 4096))
    # a row wider than a block's registers streams (read twice)
    rms_case("sweep streamed row (2,70001)", (2, 70001))
    flash_case("large prefill q (1,2048,32,64)", 1, 2048, 32, 4, 64)
    slot_case("large decode q (32,32,64) kv (32,2048,4,64)", 32, 2048, 32, 4,
              64, (2048,) * 32)
    paged_decode_case("large paged decode q (32,32,64) 32 slots x 2048 "
                      "bs=16", 32, 128, 16, 32, 4, 64, (2047,) * 32)
    paged_prefill_case("large paged prefill q (4,256,32,64) T=2048 bs=16", 4,
                       256, 128, 16, 32, 4, 64, (0, 512, 1024, 1792))
    for kvd in ("int8", "fp8"):
        paged_decode_quant_case("large paged decode q (32,32,64) 32 slots x "
                                "2048 bs=16", kvd, 32, 128, 16, 32, 4, 64,
                                (2047,) * 32)
        paged_prefill_quant_case("large paged prefill q (4,256,32,64) T=2048 "
                                 "bs=16", kvd, 4, 256, 128, 16, 32, 4, 64,
                                 (0, 512, 1024, 1792))
    # flash at the other paths' head shapes over 2048 tokens (jamba: HQ 32,
    # HKV 8, dh 128; moonshot: HQ = HKV = 16, dh 128) and with a window;
    # slot decode at moonshot's head shape and with ragged occupancy
    flash_case("large prefill jamba q (1,2048,32,128) HKV=8", 1, 2048, 32, 8,
               128)
    flash_case("large prefill moonshot q (1,2048,16,128) HKV=16", 1, 2048,
               16, 16, 128)
    flash_case("large prefill window=512 q (1,2048,32,64)", 1, 2048, 32, 4,
               64, window=512)
    slot_case("large decode moonshot q (32,16,128) kv (32,2048,16,128)", 32,
              2048, 16, 16, 128, (2048,) * 32)
    slot_case("large decode ragged q (32,32,64) kv (32,2048,4,64) lives "
              "0/1/700/2048", 32, 2048, 32, 4, 64, (0, 1, 700, 2048) * 8)
    # paged decode at jamba's head shape (HQ 32, HKV 8, dh 128, G 4) and
    # with ragged occupancy (a row with no valid key, 1, 700 and 2048 keys)
    paged_decode_case("large paged decode jamba q (32,32,128) HKV=8 32 slots "
                      "x 2048 bs=16", 32, 128, 16, 32, 8, 128, (2047,) * 32)
    paged_decode_case("large paged decode ragged q (32,32,64) lives "
                      "0/1/700/2048 bs=16", 32, 128, 16, 32, 4, 64,
                      (-1, 0, 699, 2047) * 8)
    for kvd in ("int8", "fp8"):
        paged_decode_quant_case("large paged decode jamba q (32,32,128) "
                                "HKV=8 32 slots x 2048 bs=16", kvd, 32, 128,
                                16, 32, 8, 128, (2047,) * 32)
        paged_decode_quant_case("large paged decode ragged q (32,32,64) "
                                "lives 0/1/700/2048 bs=16", kvd, 32, 128, 16,
                                32, 4, 64, (-1, 0, 699, 2047) * 8)
    # the prefill tile at the other head width the repo serves: jamba's
    # attention shape (HQ 32, HKV 8, dh 128, G 4)
    paged_prefill_case("large paged prefill dh=128 q (4,256,32,128) HKV=8 "
                       "T=2048 bs=16", 4, 256, 128, 16, 32, 8, 128,
                       (0, 512, 1024, 1792))
    for kvd in ("int8", "fp8"):
        paged_prefill_quant_case("large paged prefill dh=128 q (4,256,32,128) "
                                 "HKV=8 T=2048 bs=16", kvd, 4, 256, 128, 16,
                                 32, 8, 128, (0, 512, 1024, 1792))
    # rmsnorm at the zoo's decode rows: qwen2-7b, h2o-danube-1.8b and
    # musicgen-medium (fp32 scales), mixtral-8x7b, mistral-large-123b and
    # kimi-k2-1t-a32b (bf16 scales, as their bf16 parameters)
    for name, D, sdt in (("qwen2", 3584, torch.float32),
                         ("danube", 2560, torch.float32),
                         ("musicgen", 1536, torch.float32),
                         ("mixtral", 4096, torch.bfloat16),
                         ("mistral", 12288, torch.bfloat16),
                         ("kimi", 7168, torch.bfloat16)):
        rms_case(f"zoo {name}: decode rows (4,1,{D}) {str(sdt)[6:]} scale",
                 (SLOTS, 1, D), sdt)
    # the zoo's head shapes (paths Z1-Z7) at the main paths' slots, prompt,
    # cache and pools: qwen2-7b (G 7), mistral-large-123b (G 12),
    # h2o-danube-1.8b (dh 80) and kimi-k2-1t-a32b (dh 112), each kernel;
    # danube's window binding a 4,128-token prefill, and its decode over
    # the 4,096-key circular buffer (two slots full, two short)
    for name, HQ, HKV, dh in (("qwen2", 28, 4, 128), ("mistral", 96, 8, 128),
                              ("danube", 32, 8, 80), ("kimi", 64, 8, 112)):
        flash_case(f"zoo {name}: prefill q (1,32,{HQ},{dh}) HKV={HKV}", 1,
                   PROMPT, HQ, HKV, dh)
        slot_case(f"zoo {name}: decode q (4,{HQ},{dh}) kv (4,72,{HKV},{dh})",
                  SLOTS, MAX_LEN, HQ, HKV, dh,
                  (PROMPT + 1, PROMPT + 17, PROMPT + 32, 5))
        paged_decode_case(f"zoo {name}: paged decode q (4,{HQ},{dh}) pools "
                          f"(22,16,{HKV},{dh})", SLOTS, NB, BS, HQ, HKV, dh,
                          (32, 48, 71, 0))
        paged_prefill_case(f"zoo {name}: paged prefill q (4,24,{HQ},{dh}) "
                           "starts (0,8,24,40)", SLOTS, CHUNK_W, NB, BS, HQ,
                           HKV, dh, (0, 8, 24, 40))
    flash_case("zoo danube: prefill window=4096 q (1,4128,32,80) HKV=8", 1,
               4128, 32, 8, 80, window=4096)
    slot_case("zoo danube: decode q (4,32,80) kv (4,4096,8,80)", SLOTS, 4096,
              32, 8, 80, (4096, 4096, PROMPT + 1, PROMPT + 17))
    return cases


def quant_insert_phase():
    """The plain ``quant_insert`` (the quantized write; plain PyTorch in
    both packages, no TPU kernel) per call: one decode step's K write of 4
    slots into path C's pool (22,16,4,64), and of 32 slots into the large
    decode's pool (4098,16,4,64). Bound: the touched blocks read and
    written once, with their scales, plus the values and indices."""
    import torch
    from repro_torch.kernels import kv_quant
    out = []
    for label, P1, B in (("path C pool (22,16,4,64), 4 writes", NB * SLOTS + 2,
                          SLOTS),
                         ("large pool (4098,16,4,64), 32 writes",
                          32 * 128 + 2, 32)):
        g = torch.Generator(device="cuda").manual_seed(P1)
        for kvd in ("int8", "fp8"):
            store = kv_quant.storage_dtype(kvd, torch.float32)
            f = torch.randn(P1, BS, 4, 64, generator=g, device="cuda")
            sc = kv_quant.block_scales(f.abs().amax(dim=(1, 3)), store)
            pool = kv_quant.quantize(f, sc[:, None, :, None], store)
            blk = torch.randperm(P1 - 1, device="cuda")[:B]
            off = torch.randint(0, BS, (B,), device="cuda")
            vals = torch.randn(B, 4, 64, generator=g, device="cuda")
            call = lambda: kv_quant.quant_insert(pool, sc, blk, off, vals)
            touched = B * (2 * BS * 4 * 64 + 2 * 4 * 4)
            b_ms, b_by = bound(touched + nbytes(vals, blk, off), 0.0,
                               torch.float32)
            row = {"label": label, "kv_dtype": kvd, "ms": cuda_ms(call),
                   "device_ms": device_ms(call), "bound_ms": b_ms,
                   "bound_by": b_by}
            log("quant_insert", json.dumps(row))
            out.append(row)
    return out


def kernel_phase(gen, only: str = "", names=None):
    """Every case of ``make_cases``, or those whose label starts with
    ``only`` and, given ``names``, whose kernel is one of them."""
    import torch
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, call, plain, lib, nb, ops, *gather in make_cases(
                gen, dtype):
            if not label.startswith(only) or (names and name not in names):
                continue
            got = call()
            want = plain()
            torch.cuda.synchronize()
            err = check_close(f"{name} [{label}] {dtype}", got, want, dtype)
            row = {"label": label, "dtype": str(dtype), "max_abs_err": err}
            if label.startswith("zoo"):
                # the zoo's head shapes: fewer calls a time (20; the window
                # case's plain version takes ~0.1 s a call in fp32), no
                # device time of the plain version or the library call
                b_ms, b_by = bound(nb, ops, dtype)
                row.update(ms=cuda_ms(call, 20), plain_ms=cuda_ms(plain, 20),
                           library_ms=cuda_ms(lib, 20), bound_ms=b_ms,
                           bound_by=b_by, device_ms=device_ms(call, 20))
            elif label.startswith(("main", "large", "moe", "jamba", "wide",
                                   "verify")):
                b_ms, b_by = bound(nb, ops, dtype)
                row.update(ms=cuda_ms(call), plain_ms=cuda_ms(plain),
                           library_ms=cuda_ms(lib), bound_ms=b_ms,
                           bound_by=b_by, device_ms=device_ms(call),
                           plain_device_ms=device_ms(plain),
                           library_device_ms=device_ms(lib))
                if name == "rmsnorm" and "decode" in label:
                    row.update(cold_device_ms=cold_device_ms(call, name))
                if label.startswith("verify"):
                    row["device_ms"], row["device_mean_ms"] = (
                        kernel_device_ms(call, name,
                                         symbol="paged_prefill_kernel"))
                if gather:
                    row.update(library_gather_ms=cuda_ms(gather[0]),
                               library_gather_device_ms=device_ms(gather[0]))
            log(f"kernel {name:15s} {str(dtype):15s} {label:45s} "
                + " ".join(f"{k}={v!r}" for k, v in row.items()
                           if k not in ("label", "dtype")))
            records.setdefault(name, []).append(row)
    return records


def route_cases(gen, dtype):
    """moe_route cases: (label, x, router, k, exact). The main path's
    shapes (a decode microstep's 4 tokens and an admission's 32, D 2048,
    E 64, k 6), a sweep (tests/test_kernels.py's shapes, N 1 / 33 / 100,
    E 4-256, k 1 / 2 / 4 / E, D 16-8192), one case of exact ties and one
    large N. x at unit scale and the router at the init's std 0.02, as
    the model feeds it (an RMS-normed x). The tie case (``exact``) has
    small-integer x and a router of equal column pairs at multiples of
    2^-5: every logit is exact in any summation order, every probability
    comes twice, and the lower index must win each pair."""
    import torch

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    cases = []
    for label, N, D, E, k in (
            ("main: decode microstep x (4,2048) router (2048,64) k=6",
             SLOTS, 2048, 64, 6),
            ("main: admission x (32,2048) router (2048,64) k=6", PROMPT,
             2048, 64, 6),
            ("jamba: decode microstep x (4,4096) router (4096,16) k=2",
             SLOTS, 4096, 16, 2),
            ("jamba: admission x (32,4096) router (4096,16) k=2", PROMPT,
             4096, 16, 2),
            ("sweep N=100 D=64 E=16 k=4", 100, 64, 16, 4),
            ("sweep N=64 D=32 E=8 k=1", 64, 32, 8, 1),
            ("sweep N=33 D=16 E=4 k=2", 33, 16, 4, 2),
            ("sweep N=1 D=64 E=8 k=2", 1, 64, 8, 2),
            ("sweep N=33 D=100 E=16 k=4", 33, 100, 16, 4),
            ("sweep k=E N=3 D=96 E=8 k=8", 3, 96, 8, 8),
            ("sweep N=5 D=8192 E=256 k=8", 5, 8192, 256, 8),
            # past the old kernel's E <= 256: E 100 (not a whole 16-byte
            # group in bf16) at decode and at prefill (D 99: element
            # staging), k = E at E 384, E 512, 1024 and 2048, a prefill
            # of 6 expert slices whose D is split too, and E 1
            ("sweep N=7 D=300 E=100 k=6", 7, 300, 100, 6),
            ("sweep N=70 D=99 E=100 k=6", 70, 99, 100, 6),
            ("sweep k=E N=5 D=64 E=384 k=384", 5, 64, 384, 384),
            ("sweep N=5 D=100 E=512 k=8", 5, 100, 512, 8),
            ("sweep N=3 D=64 E=1024 k=4", 3, 64, 1024, 4),
            ("sweep N=2 D=32 E=2048 k=2", 2, 32, 2048, 2),
            ("sweep N=300 D=256 E=384 k=8", 300, 256, 384, 8),
            ("sweep N=3 D=40 E=1 k=1", 3, 40, 1, 1),
            # kimi-k2-1t-a32b's router: D 7168, E 384, top-8
            ("kimi: decode microstep x (4,7168) router (7168,384) k=8",
             SLOTS, 7168, 384, 8),
            ("kimi: admission x (32,7168) router (7168,384) k=8", PROMPT,
             7168, 384, 8),
            # mixtral-8x7b's router (path Z5): D 4096, E 8, top-2
            ("mixtral: decode microstep x (4,4096) router (4096,8) k=2",
             SLOTS, 4096, 8, 2),
            ("mixtral: admission x (32,4096) router (4096,8) k=2", PROMPT,
             4096, 8, 2),
            ("large N=4096 D=2048 E=64 k=6", 4096, 2048, 64, 6)):
        cases.append((label, rn(N, D), rn(D, E, scale=0.02), k, False))
    for label, N, D, E, k in (
            ("ties: x (64,2048) integers, router column pairs equal k=6", 64,
             2048, 64, 6),
            ("sweep ties: x (100,7168) integers, router (7168,384) column "
             "pairs equal k=8", 100, 7168, 384, 8)):
        x = torch.randint(-1, 2, (N, D), generator=gen, device="cuda")
        half = torch.randint(-1, 2, (D, E // 2), generator=gen, device="cuda")
        cases.append((label, x.to(dtype),
                      (half * 2.0 ** -5).repeat_interleave(2, dim=1).to(dtype),
                      k, True))
    return cases


def check_route(name, got, want, x, w, k, exact):
    """The router kernel against its plain version: gates within 1e-5 on
    every row; indices equal, except where the plain probabilities nearly
    tie and a summation order decides. A row may differ only (a) in the
    order of experts whose plain gates lie within 1e-6 of each other, or
    (b) in its k-th expert when the plain k-th and (k+1)-th probabilities
    lie within 1e-6. The ``exact`` (tie) case allows neither, and its
    equal column pairs must come out lower index first. Returns (max |gate
    error|, rows of kind a, rows of kind b)."""
    import torch
    from repro_torch.kernels import ref
    (gg, gi), (wg, wi) = got, want
    err = (gg - wg).abs().max().item()
    if not bool(torch.isfinite(gg).all()) or err > 1e-5:
        raise AssertionError(f"{name}: gates differ by {err:.3e} (tolerance "
                             "1e-5)")
    E = w.shape[1]
    differ = (gi != wi).any(-1).nonzero()[:, 0].tolist()
    reordered = swapped = 0
    top = ref.moe_route_ref(x, w, min(k + 1, E))[0] if differ else None
    for r in differ:
        a, b = gi[r].tolist(), wi[r].tolist()
        pos = gi[r] != wi[r]
        if not exact and sorted(a) == sorted(b) and (
                wg[r][pos].max() - wg[r][pos].min()).item() <= 1e-6:
            reordered += 1
        elif (not exact and k < E and a[:-1] == b[:-1]
              and (top[r, k - 1] - top[r, k]).item() <= 1e-6):
            swapped += 1
        else:
            raise AssertionError(f"{name}: row {r} routes to {a}, the plain "
                                 f"version to {b}")
    if exact and not (bool((gi[:, 0::2] % 2 == 0).all())
                      and torch.equal(gi[:, 1::2], gi[:, 0::2] + 1)):
        raise AssertionError(f"{name}: a tie did not go to the lower index")
    return err, reordered, swapped


def route_phase(gen, only=""):
    """moe_route against ``moe_route_ref`` on the card, float32 and
    bfloat16 inputs; the main and large cases timed like the other
    kernels. Library yardstick: ``torch.topk(torch.softmax(x.float() @
    router.float(), -1), k)``, three PyTorch calls (the port never makes
    them). Bound: bytes of x, router, gates and indices over 3.35 TB/s, or
    the 2·N·D·E operations over the input type's peak. ``only``: the
    cases whose label starts with it (or with one of a tuple). The decode
    shapes also get an L2-cold device time (``cold_device_ms``)."""
    import torch
    from repro_torch.kernels import ops, ref
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, x, w, k, exact in route_cases(gen, dtype):
            if not label.startswith(only):
                continue
            call = lambda: ops.moe_route(x, w, k)  # noqa: E731
            plain = lambda: ref.moe_route_ref(x, w, k)  # noqa: E731
            got, want = call(), plain()
            torch.cuda.synchronize()
            err, reordered, swapped = check_route(
                f"moe_route [{label}] {dtype}", got, want, x, w, k, exact)
            row = {"label": label, "dtype": str(dtype), "max_abs_err": err,
                   "near_tie_rows_reordered": reordered,
                   "near_tie_rows_kth_swapped": swapped}
            if label.startswith(("main", "large", "jamba", "kimi",
                                 "mixtral")):
                N, D = x.shape
                lib = lambda: torch.topk(torch.softmax(  # noqa: E731
                    x.float() @ w.float(), -1), k)
                b_ms, b_by = bound(nbytes(x, w, *got), 2.0 * N * D *
                                   w.shape[1], dtype)
                row.update(ms=cuda_ms(call), plain_ms=cuda_ms(plain),
                           library_ms=cuda_ms(lib), bound_ms=b_ms,
                           bound_by=b_by, device_ms=device_ms(call),
                           plain_device_ms=device_ms(plain),
                           library_device_ms=device_ms(lib))
                if "decode" in label:
                    row.update(cold_device_ms=cold_device_ms(call, "route"))
            log(f"kernel {'moe_route':15s} {str(dtype):15s} {label:45s} "
                + " ".join(f"{k_}={v!r}" for k_, v in row.items()
                           if k_ not in ("label", "dtype")))
            rows.append(row)
    return rows


def _scan_row(kernel, label, dtype, call, plain, err, n_bytes, n_ops, slow):
    """The record of one scan case; a main or large case timed like the
    other kernels (the plain version ``slow`` calls), its device time
    read both ways (``kernel_device_ms``), and a main case's L2-cold
    device time."""
    row = {"label": label, "dtype": str(dtype), "max_abs_err": err}
    if label.startswith(("main", "large")):
        b_ms, b_by = bound(n_bytes, n_ops, "torch.float32")
        dev, mean = kernel_device_ms(call, kernel)
        row.update(ms=cuda_ms(call), library_ms=None, bound_ms=b_ms,
                   bound_by=b_by, device_ms=dev, device_mean_ms=mean,
                   library_device_ms=None,
                   plain_ms=cuda_ms(plain, iters=slow, warmup=1),
                   plain_device_ms=device_ms(plain, iters=slow))
        if label.startswith("main"):
            cold, cold_mean = kernel_device_ms(call, kernel,
                                               between=l2_flush())
            row.update(cold_device_ms=cold, cold_device_mean_ms=cold_mean)
    return row


def _log_row(kernel, row):
    log(f"kernel {kernel:15s} {row['dtype']:15s} {row['label']:45s} "
        + " ".join(f"{k}={v!r}" for k, v in row.items()
                   if k not in ("label", "dtype")))


def _refused(kernel, label, dtype, exc, refused_ok):
    """A case the kernel's wrapper refused: logged and skipped where
    ``refused_ok`` (``compare`` over an older tree, whose kernels took
    less), raised otherwise."""
    if not refused_ok:
        raise exc
    log(f"kernel {kernel:15s} {str(dtype):15s} {label:45s} refused by this "
        f"tree: {type(exc).__name__}: {exc}")


def rwkv_inputs(gen, B, S, nh, hd, dtype, udtype):
    """r, k, v unit normals, w = exp(-exp(n - 2)), u at 0.5 (as
    tests/test_kernels.py draws them), r, k, v, w in ``dtype`` and u in
    ``udtype``."""
    import torch

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    shape = (B, S, nh, hd)
    return tuple(t.to(d) for t, d in (
        (rn(*shape), dtype), (rn(*shape), dtype), (rn(*shape), dtype),
        (torch.exp(-torch.exp(rn(*shape) - 2)), dtype),
        (rn(nh, hd) * 0.5, udtype)))


def rwkv_scan_phase(gen, refused_ok=False):
    """rwkv_scan against ``rwkv_scan_ref`` on the card, y and the final
    state within 1e-4 (the kernel and the plain version both widen their
    inputs exactly and compute in float32, so bfloat16 inputs take the
    float32 gate too): the RWKV path's admission shape (1,32,64,64)
    (rwkv6-7b: nh 64, hd 64), a sweep (hd 16 to 512 -- 100 and 33 take 16-
    and 4-byte staged copies, and element copies in bfloat16; 192, 256 and
    512 take 16 and 32 key rows a lane --, nh 3, S 1, 31 and 70, B 2),
    bfloat16 r, k, v, w with u in bfloat16 or float32, and (4,1024,64,64)
    (inputs from ``rwkv_inputs``). The main and large cases timed like the
    other kernels, with the final state stored, as the prefill asks for
    it; the admission also L2-cold. Bound: r, k, v, w, u read once, y and
    the state written once, over 3.35 TB/s, or the function's 5 hd² + 5 hd
    flops per (token, head) over the fp32 peak (the read-out Σ r S one fma
    per state element, the decay and add w S + k v a multiply and an fma,
    the bonus v·Σ r u k per token). No PyTorch call computes the
    recurrence: the library time is null. ``refused_ok``: see
    ``_refused``."""
    import torch
    from repro_torch.kernels import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for label, B, S, nh, hd, dtype, udtype in (
            ("main: admission (1,32,64,64)", 1, PROMPT, 64, 64, f32, f32),
            ("sweep B=2 S=1 nh=3 hd=16", 2, 1, 3, 16, f32, f32),
            ("sweep B=2 S=31 nh=3 hd=32", 2, 31, 3, 32, f32, f32),
            ("sweep B=2 S=70 nh=3 hd=16", 2, 70, 3, 16, f32, f32),
            ("sweep B=2 S=70 nh=3 hd=32", 2, 70, 3, 32, f32, f32),
            ("sweep B=2 S=31 nh=1 hd=64", 2, 31, 1, 64, f32, f32),
            ("sweep B=1 S=9 nh=2 hd=128", 1, 9, 2, 128, f32, f32),
            ("sweep B=1 S=5 nh=2 hd=100", 1, 5, 2, 100, f32, f32),
            ("sweep B=2 S=9 nh=3 hd=33", 2, 9, 3, 33, f32, f32),
            ("sweep B=1 S=9 nh=2 hd=192", 1, 9, 2, 192, f32, f32),
            ("sweep B=2 S=5 nh=2 hd=256", 2, 5, 2, 256, f32, f32),
            ("sweep B=1 S=3 nh=1 hd=512", 1, 3, 1, 512, f32, f32),
            ("sweep 8 columns a lane B=8 S=3 nh=40 hd=100", 8, 3, 40, 100,
             f32, f32),
            ("main: admission (1,32,64,64)", 1, PROMPT, 64, 64, bf16, bf16),
            ("sweep u f32 B=2 S=31 nh=3 hd=64", 2, 31, 3, 64, bf16, f32),
            ("sweep B=2 S=9 nh=3 hd=33", 2, 9, 3, 33, bf16, bf16),
            ("sweep B=1 S=5 nh=2 hd=100", 1, 5, 2, 100, bf16, bf16),
            ("sweep B=1 S=9 nh=2 hd=192", 1, 9, 2, 192, bf16, bf16),
            ("sweep B=2 S=5 nh=2 hd=256", 2, 5, 2, 256, bf16, f32),
            ("sweep 8 columns a lane B=8 S=3 nh=40 hd=33", 8, 3, 40, 33, bf16,
             bf16),
            ("large (4,1024,64,64)", 4, 1024, 64, 64, f32, f32)):
        ins = rwkv_inputs(gen, B, S, nh, hd, dtype, udtype)
        call = lambda: ops.rwkv_scan(*ins)  # noqa: E731
        plain = lambda: ref.rwkv_scan_ref(*ins)  # noqa: E731
        try:
            y, st = call()
        except (ValueError, TypeError) as exc:
            _refused("rwkv_scan", label, dtype, exc, refused_ok)
            continue
        wy, ws = plain()
        torch.cuda.synchronize()
        err = max(check_close(f"rwkv_scan [{label}] {dtype} u {udtype} "
                              f"{what}", got, want, f32)
                  for what, got, want in (("y", y, wy), ("state", st, ws)))
        slow = 3 if S > PROMPT else 50       # the plain loop over S
        row = _scan_row("rwkv_scan", label, dtype, call, plain, err,
                        nbytes(*ins, y, st), rwkv_scan_ops(B, S, nh, hd),
                        slow)
        if udtype != dtype:
            row["u_dtype"] = str(udtype)
        _log_row("rwkv_scan", row)
        rows.append(row)
    return rows


#: the H100 SXM's special-function units: 16 exps per clock per SM, 132
#: SMs, 1.98 GHz boost (data sheet and Hopper white paper)
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def mamba_inputs(gen, B, S, di, ds, dtype):
    """x at 0.5, dt = softplus(n - 1), A = -exp(0.3 n), B and C unit
    normals (as tests/test_kernels.py draws them); A in float32, the rest
    in ``dtype``."""
    import torch
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = (rn(B, S, di) * 0.5).to(dtype)
    dt = F.softplus(rn(B, S, di) - 1).to(dtype)
    A = -torch.exp(rn(di, ds) * 0.3)
    return x, dt, A, rn(B, S, ds).to(dtype), rn(B, S, ds).to(dtype)


def mamba_scan_phase(gen, refused_ok=False):
    """mamba_scan against ``mamba_scan_ref`` on the card, y and the final
    state, float32 within 1e-4 and bfloat16 inputs within 2e-2 (dt·x is
    rounded to bfloat16 in both): the Mamba path's admission shape
    (1,32,8192,16) (jamba-v0.1-52b: di 8192, ds 16), tests/test_kernels.py's
    sweep ((2,100,96,8), (1,64,64,4), (2,33,128,16)) with S = 1, a ragged
    di, B = 4, odd ds, ds 32, 64, 100 (bfloat16 rows of 200 bytes: 8-byte
    copies), 128 and 256 (8 and 16 states a lane over 16 lanes), a ragged
    last block at B 8, and one larger shape (inputs from
    ``mamba_inputs``). The main and large cases timed like the other
    kernels, the admission also L2-cold. Bound: x, dt, A, B, C read once,
    y and the state written once, over 3.35 TB/s, or the function's 7
    operations per (token, channel, state) (dt A, exp, (dt x) B, a h + bx,
    h C summed) plus dt x per (token, channel) over the fp32 peak; beside
    it the exps alone over the SFUs' rate. No PyTorch call computes the
    selective scan: the library time is null. ``refused_ok``: see
    ``_refused``."""
    import torch
    from repro_torch.kernels import ops, ref
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, S, di, ds in (
                ("main: admission (1,32,8192,16)", 1, PROMPT, 8192, 16),
                ("sweep (2,100,96,8)", 2, 100, 96, 8),
                ("sweep (1,64,64,4)", 1, 64, 64, 4),
                ("sweep (2,33,128,16)", 2, 33, 128, 16),
                ("sweep S=1 (2,1,96,8)", 2, 1, 96, 8),
                ("sweep ragged di (1,40,100,16)", 1, 40, 100, 16),
                ("sweep B=4 (4,20,64,16)", 4, 20, 64, 16),
                ("sweep odd ds (2,17,70,5)", 2, 17, 70, 5),
                ("sweep ds=32 (1,9,40,32)", 1, 9, 40, 32),
                ("sweep ds=64 (2,9,72,64)", 2, 9, 72, 64),
                ("sweep ds=100 (1,7,40,100)", 1, 7, 40, 100),
                ("sweep ds=128 (1,9,48,128)", 1, 9, 48, 128),
                ("sweep ds=256 (2,5,20,256)", 2, 5, 20, 256),
                ("sweep ragged block (8,6,4098,16)", 8, 6, 4098, 16),
                ("large (4,1024,8192,16)", 4, 1024, 8192, 16)):
            ins = mamba_inputs(gen, B, S, di, ds, dtype)
            call = lambda: ops.mamba_scan(*ins)  # noqa: E731
            plain = lambda: ref.mamba_scan_ref(*ins)  # noqa: E731
            try:
                y, h = call()
            except (ValueError, TypeError) as exc:
                _refused("mamba_scan", label, dtype, exc, refused_ok)
                continue
            wy, wh = plain()
            torch.cuda.synchronize()
            err = max(check_close(f"mamba_scan [{label}] {what}", got, want,
                                  dtype)
                      for what, got, want in (("y", y, wy),
                                              ("state", h, wh)))
            elems = B * S * di * ds
            slow = 3 if S > PROMPT else 50   # the plain loop over S
            row = _scan_row("mamba_scan", label, dtype, call, plain, err,
                            nbytes(*ins, y, h),
                            mamba_scan_ops(B, S, di, ds), slow)
            if "ms" in row:
                row["sfu_exp_ms"] = elems / SFU_EXP_PER_S * 1e3
            _log_row("mamba_scan", row)
            rows.append(row)
    return rows


def scan_tiles_phase(gen):
    """Both scans at their paths' admissions and large shapes in float32
    under every lane tile their sources instantiate that pads the state
    at most 2x (rwkv: key rows x value columns; mamba: states a lane x
    lanes a channel), each checked against the plain version (within
    1e-4) and read by its device time both ways (``kernel_device_ms``) and
    by CUDA events over back-to-back calls (at the large shapes the two
    agree; at the admissions the latter is the host's launch cost); the
    geometry functions' own choice is marked."""
    import torch
    from repro_torch.kernels import mamba_ssm, ref, rwkv6
    for B, S, nh, hd in ((1, PROMPT, 64, 64), (4, 1024, 64, 64)):
        ins = rwkv_inputs(gen, B, S, nh, hd, torch.float32, torch.float32)
        want = ref.rwkv_scan_ref(*ins)
        chosen = rwkv6.rwkv_geometry(B, S, nh, hd)
        for tile, (ti, _) in enumerate(rwkv6.TILES):
            if not hd <= rwkv6.LANES * ti < 4 * hd:
                continue
            g = rwkv6.tile_geometry(S, hd, tile)
            _tile_row("rwkv_scan", (B, S, nh, hd), f"{g.ti}x{g.tj} "
                      f"slices={g.slices}", g == chosen, want,
                      lambda: rwkv6._launch(*ins, geometry=g))  # noqa: B023
    for B, S, di, ds in ((1, PROMPT, 8192, 16), (4, 1024, 8192, 16)):
        ins = mamba_inputs(gen, B, S, di, ds, torch.float32)
        want = ref.mamba_scan_ref(*ins)
        chosen = mamba_ssm.mamba_geometry(S, ds)
        for tile, (ns, lanes) in enumerate(mamba_ssm.TILES):
            if not ds <= ns * lanes < 4 * ds:
                continue
            g = mamba_ssm.tile_geometry(S, tile)
            _tile_row("mamba_scan", (B, S, di, ds), f"{ns} states x {lanes} "
                      f"lanes", g == chosen, want,
                      lambda: mamba_ssm._launch(*ins, geometry=g))  # noqa: B023


def _tile_row(kernel, shape, name, chosen, want, call):
    import torch
    got = call()
    torch.cuda.synchronize()
    err = max(check_close(f"{kernel} {shape} tile {name} {what}", a, b,
                          torch.float32)
              for what, a, b in zip(("y", "state"), got, want))
    dev, mean = kernel_device_ms(call, kernel)
    log(f"tile {kernel:15s} {str(shape):22s} {name:22s} chosen={chosen} "
        f"max_abs_err={err!r} device_ms={dev!r} device_mean_ms={mean!r} "
        f"ms={cuda_ms(call, iters=20)!r}")


# ---------------------------------------------------------------------------
# the main path and the teacher-forced check
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def last_streams(out: dict, fleet: bool = False):
    """While open, ``out["streams"]`` holds the token streams of the last
    ``ServeEngine.run`` (``fleet``: ``FleetEngine.run``; a launcher's timed
    run follows its warm one)."""
    from repro_torch.serve import FleetEngine, ServeEngine
    kind = FleetEngine if fleet else ServeEngine
    run = kind.run

    def spy(self, requests, **kw):
        comps, wall = run(self, requests, **kw)
        out["streams"] = {c.rid: c.tokens.tolist() for c in comps}
        return comps, wall
    kind.run = spy
    try:
        yield out
    finally:
        kind.run = run


def path_phase():
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_engine, run_server

    ops.reset_launch_counts()
    with last_streams({}) as slot_out:
        rep = run_engine(main_config(), PRESET, n_slots=SLOTS,
                         prompt_len=PROMPT, gen_len=GEN, requests=REQUESTS,
                         load="open", smoke=False, device="cuda")
    open_counts = ops.launch_counts()
    log("serve report (open):", json.dumps(rep))
    log("launches (open):", open_counts)
    if rep["requests"] != REQUESTS or rep["total_tokens"] != REQUESTS * GEN:
        raise AssertionError(f"open load: {rep['requests']} requests, "
                             f"{rep['total_tokens']} tokens; want "
                             f"{REQUESTS} x {GEN}")

    ops.reset_launch_counts()
    seq = run_server(main_config(), PRESET, batch=1, prompt_len=PROMPT,
                     gen_len=GEN, requests=REQUESTS, smoke=False,
                     device="cuda")
    seq_counts = ops.launch_counts()
    log("serve report (seq):", json.dumps(seq))
    log("launches (seq):", seq_counts)
    if seq["total_tokens"] != REQUESTS * GEN:
        raise AssertionError(f"seq load produced {seq['total_tokens']} "
                             f"tokens, want {REQUESTS * GEN}")
    for what, counts in (("open", open_counts), ("seq", seq_counts)):
        for k in ("rmsnorm", "flash_attention", "slot_decode"):
            if counts.get(k, 0) < 1:
                raise AssertionError(f"--load {what}: kernel {k} was never "
                                     "launched on the main path")

    # the paged paths: A, two-phase with a shared prefix (later admissions
    # take the suffix prefill over a radix-shared block); B, chunked, each
    # 32-token prompt entering in chunks of at most 24 (the second one
    # starting mid-block)
    # C and D: A and B over quantized pools (int8, fp8), through the
    # fused-dequant kernels only
    paged = {}
    unquantized = ("paged_decode", "paged_prefill")
    quantized = ("paged_decode_quant", "paged_prefill_quant")
    for name, kw, want, never in (
            ("A", dict(shared_prefix_len=SHARED),
             ("paged_decode", "flash_attention", "rmsnorm"), quantized),
            ("B", dict(chunked=True, budget=BUDGET, chunk_width=CHUNK_W),
             ("paged_decode", "paged_prefill", "rmsnorm"), quantized),
            ("C", dict(shared_prefix_len=SHARED, kv_dtype="int8"),
             ("paged_decode_quant", "flash_attention", "rmsnorm"),
             unquantized),
            ("D", dict(chunked=True, budget=BUDGET, chunk_width=CHUNK_W,
                       kv_dtype="fp8"),
             ("paged_prefill_quant", "paged_decode_quant", "rmsnorm"),
             unquantized)):
        ops.reset_launch_counts()
        with last_streams({}) as out:
            rep_p = run_engine(main_config(), PRESET, n_slots=SLOTS,
                               prompt_len=PROMPT, gen_len=GEN,
                               requests=REQUESTS, load="open", smoke=False,
                               device="cuda", kv="paged", block_size=BS,
                               **kw)
        counts = ops.launch_counts()
        log(f"serve report (paged path {name}):", json.dumps(rep_p))
        log(f"launches (paged path {name}):", counts)
        log(f"paged path {name}: kv_prefix_shared_tokens "
            f"{rep_p['kv_prefix_shared_tokens']}, kv_cow_forks "
            f"{rep_p['kv_cow_forks']}, kv_blocks_hwm {rep_p['kv_blocks_hwm']}")
        if (rep_p["requests"] != REQUESTS
                or rep_p["total_tokens"] != REQUESTS * GEN):
            raise AssertionError(f"paged path {name}: {rep_p['requests']} "
                                 f"requests, {rep_p['total_tokens']} tokens; "
                                 f"want {REQUESTS} x {GEN}")
        for k in want:
            if counts.get(k, 0) < 1:
                raise AssertionError(f"paged path {name}: kernel {k} was "
                                     "never launched")
        for k in never:
            if counts.get(k, 0):
                raise AssertionError(f"paged path {name} ({rep_p['kv_dtype']}"
                                     f" pools) launched {k}")
        ratio = (paged["A"][0]["kv_bytes_per_block"]
                 / rep_p["kv_bytes_per_block"]) if paged else 1.0
        log(f"paged path {name}: kv_dtype {rep_p['kv_dtype']}, "
            f"kv_bytes_per_block {rep_p['kv_bytes_per_block']}, "
            f"kv_bytes_per_shard {rep_p['kv_bytes_per_shard']}, "
            f"path A's bytes per block / this path's {ratio:.4f}")
        if name in ("C", "D") and ratio < 1.9:
            raise AssertionError(f"paged path {name}: blocks only "
                                 f"{ratio:.3f}x smaller than path A's")
        paged[name] = (rep_p, counts, out["streams"])
    return rep, seq, open_counts, paged, slot_out["streams"]


def teacher_forced_phase(steps: int = 8, tol: float = 2e-3):
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import L3_NSS, preset
    from repro_torch.launch.mesh_cases import paged_writes
    from repro_torch.models import (ModelOptions, decode_step,
                                    decode_step_paged, decode_step_slots,
                                    init_params, prefill,
                                    serve_chunk_step_paged)
    from repro_torch.models.transformer import clone_cache
    from repro_torch.serve import ServeEngine, slotify, synthetic_requests
    from repro_torch.serve.paging import init_paged_cache, scatter_kv

    cfg = main_config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    plain = ModelOptions(attn_impl="ref", dtype=torch.float32)
    kern = preset(PRESET).model_options(plain)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PROMPT),
                                         dtype=np.int32)).cuda()
    lp0, cp0 = prefill(params, toks, cfg, plain, MAX_LEN)
    lk0, ck0 = prefill(params, toks, cfg, kern, MAX_LEN)
    worst0 = (lp0 - lk0).abs().max().item()

    def check(what, worst, scale):
        log(f"teacher-forced ({what}) max |dlogit|: {worst:.3e} (tolerance "
            f"{tol}; logit scale {scale:.3g})")
        if not math.isfinite(worst) or worst > tol:
            raise AssertionError(f"teacher-forced ({what}) logits differ by "
                                 f"{worst}")

    # paged: the prefill's first n positions scattered into a pool of
    # 3 * NB blocks through a permuted, non-contiguous table
    P = 3 * NB
    table = torch.randperm(P, generator=torch.Generator().manual_seed(1))[
        :NB].to(torch.int32)[None].cuda()

    def paged_from(c, n, kv_dtype="bf16"):
        pc = init_paged_cache(cfg, P, BS, 1, torch.float32, "cuda",
                              kv_dtype=kv_dtype)
        p = torch.arange(n, device="cuda")
        scatter_kv(pc, [{"k": g["k"][:, :n], "v": g["v"][:, :n]} for g in c],
                   table[0, p // BS].long(), p % BS, 0, n)
        return pc

    # slotted decode (the engine's), uniform decode (``--load seq``, the
    # mask built from slot_pos/pos in ops.decode_attention) and paged
    # decode (paths A and B), each from a copy of the prefilled caches
    paged_step = lambda p, c, t, cf, o: decode_step_paged(  # noqa: E731
        p, c, t, table, cf, o, MAX_LEN)
    control = []                      # the fp32 paged run's (token, logits)
    for what, step, layout in (
            ("slotted", decode_step_slots, lambda c: slotify(clone_cache(c))),
            ("uniform", decode_step, clone_cache),
            ("paged", paged_step, lambda c: paged_from(c, PROMPT))):
        lp, lk = lp0, lk0
        cp, ck = layout(cp0), layout(ck0)
        worst = worst0
        for _ in range(steps):
            nxt = torch.argmax(lp, -1).to(torch.int32)   # the plain token
            lp, cp = step(params, cp, nxt, cfg, plain)
            lk, ck = step(params, ck, nxt, cfg, kern)
            worst = max(worst, (lp - lk).abs().max().item())
            if what == "paged":
                control.append((nxt, lp))
        torch.cuda.synchronize()
        check(f"{what}, prefill + {steps} decode steps", worst,
              lp.abs().max().item())

    # path C's decode over an int8 pool, fed the fp32 paged run's tokens.
    # Quantization is discontinuous: an ulp of difference in K (the
    # kernels' summation order upstream) can move a code by a whole step.
    # So the gated comparison starts both paths from the plain prefill's
    # pool and has the kernel path replay the plain path's K/V writes
    # (``paged_writes``): the pools stay bit-identical and only the
    # kernels' arithmetic differs. The kernel path writing its own K/V
    # from its own prefill, and the plain path against the fp32 control
    # (the format's error), are printed, not gated.
    cp, ck = paged_from(cp0, PROMPT, "int8"), paged_from(cp0, PROMPT, "int8")
    ck_own = paged_from(ck0, PROMPT, "int8")
    worst, own, fmt = worst0, 0.0, 0.0
    for nxt, lctl in control:
        writes = []
        with paged_writes(writes, replay=False):
            lp, cp = paged_step(params, cp, nxt, cfg, plain)
        with paged_writes(writes, replay=True):
            lk, ck = paged_step(params, ck, nxt, cfg, kern)
        lko, ck_own = paged_step(params, ck_own, nxt, cfg, kern)
        worst = max(worst, (lp - lk).abs().max().item())
        own = max(own, (lp - lko).abs().max().item())
        fmt = max(fmt, (lp - lctl).abs().max().item())
    torch.cuda.synchronize()
    check(f"int8 paged, prefill + {steps} decode steps, K/V writes shared",
          worst, lp.abs().max().item())
    log(f"int8 paged decode, each path writing its own K/V: max |dlogit| "
        f"{own:.4e}; plain vs the fp32 control: {fmt:.4e} (not gated)")

    # path B's chunk pass: positions 0..7 resident, then one 24-token chunk
    # at position 8 (starting mid-block); its logits at position 31 are the
    # prefill's
    start = torch.tensor([8], dtype=torch.int32, device="cuda")
    clen = torch.tensor([PROMPT - 8], dtype=torch.int32, device="cuda")
    lp, _ = serve_chunk_step_paged(params, paged_from(cp0, 8), toks[:, 8:],
                                   table, start, clen, cfg, plain, MAX_LEN)
    lk, _ = serve_chunk_step_paged(params, paged_from(ck0, 8), toks[:, 8:],
                                   table, start, clen, cfg, kern, MAX_LEN)
    torch.cuda.synchronize()
    log(f"serve_chunk_step_paged (plain) vs prefill (plain) at position "
        f"{PROMPT - 1}: max |dlogit| {(lp - lp0).abs().max().item():.3e}")
    check("paged chunk pass, 24 tokens at position 8",
          (lp - lk).abs().max().item(), lp.abs().max().item())
    # path D's chunk pass over an fp8 pool, gated as path C's decode (K/V
    # writes shared); each path's own writes and the fp32 control printed
    def fp8_chunk(c0, opts):
        return serve_chunk_step_paged(params, paged_from(c0, 8, "fp8"),
                                      toks[:, 8:], table, start, clen, cfg,
                                      opts, MAX_LEN)[0]

    writes = []
    with paged_writes(writes, replay=False):
        lq = fp8_chunk(cp0, plain)
    with paged_writes(writes, replay=True):
        lkq = fp8_chunk(cp0, kern)
    lko = fp8_chunk(ck0, kern)
    torch.cuda.synchronize()
    check("fp8 paged chunk pass, 24 tokens at position 8, K/V writes "
          "shared", (lq - lkq).abs().max().item(), lq.abs().max().item())
    log(f"fp8 paged chunk pass, each path writing its own K/V: max |dlogit| "
        f"{(lq - lko).abs().max().item():.4e}; plain vs the fp32 control: "
        f"{(lq - lp).abs().max().item():.4e} (not gated)")

    # engine streams (kernels) vs sequential streams (plain): printed only
    lk_cfg = dataclasses.replace(preset(PRESET), decode_steps=8)
    assert lk_cfg.level == L3_NSS
    reqs = synthetic_requests(4, PROMPT, 16, cfg.vocab_size, seed=3,
                              shared_prefix_len=SHARED)
    want = {}
    for req in reqs:
        lg, cache = prefill(params, torch.from_numpy(req.prompt)[None].cuda(),
                            cfg, plain, MAX_LEN)
        out = [int(torch.argmax(lg, -1))]
        for _ in range(req.max_new_tokens - 1):
            nxt = torch.tensor(out[-1:], dtype=torch.int32, device="cuda")
            lg, cache = decode_step(params, cache, nxt, cfg, plain)
            out.append(int(torch.argmax(lg, -1)))
        want[req.rid] = out
    for what, kw in (("slotted", {}),
                     ("paged", dict(kv="paged", block_size=BS)),
                     ("paged chunked", dict(kv="paged", block_size=BS,
                                            chunked=True, chunk_budget=BUDGET,
                                            chunk_width=CHUNK_W))):
        eng = ServeEngine(cfg, params, kern, lk_cfg, n_slots=2,
                          max_len=MAX_LEN, **kw)
        comps, _ = eng.run(reqs, load="closed")
        agree = sum(int(a == b) for c in comps
                    for a, b in zip(c.tokens.tolist(), want[c.rid]))
        total = sum(len(w) for w in want.values())
        log(f"engine ({what}, kernels) vs sequential (plain) stream "
            f"agreement: {agree}/{total} tokens")


def _profile_run(label, eng, reqs, also=()):
    """Wall time of ``eng`` serving ``reqs`` (host clock, unprofiled,
    ending in a synchronise) after a warm run, then the device busy time
    of an identical run under ``torch.profiler`` (CUDA activity), summed
    from the profiler's raw records: building its event tree, which
    ``key_averages`` needs, takes minutes at these runs' hundreds of
    thousands of launches. Idle share = 1 - busy / wall. Prints the top
    kernels by device time, those whose names hold one of ``also`` below
    them, and the host-to-device copies. ``eng`` is a ``ServeEngine`` or a
    ``FleetEngine`` (its replicas' programs summed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng.run(reqs, load="closed")                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs, load="closed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(reqs, load="closed")
        torch.cuda.synchronize()
    by = {name: (us, n) for name, (n, us) in _device_events(prof).items()}
    busy = sum(us for us, _ in by.values()) / 1e6
    tokens = sum(r.max_new_tokens for r in reqs)
    programs = sum(e.programs_run for e in getattr(eng, "engines", [eng]))
    log(f"profile ({label}): wall {wall:.6f} s, device busy {busy:.6f} s, "
        f"idle share {1 - busy / wall:.4f}, tokens/s {tokens / wall:.6g}, "
        f"programs {programs}, device records "
        f"{sum(n for _, n in by.values())}")
    ranked = sorted(by.items(), key=lambda kv: -kv[1][0])
    named = [kv for kv in ranked[12:] if any(a in kv[0] for a in also)]
    for name, (us, n) in ranked[:12] + named:
        log(f"  device {us / 1e3:10.3f} ms  x{n:6d}  {name[:110]}")
    # host-to-device copies: the paged engine's block tables (built in
    # numpy on the host) cross once per program
    h2d = [v for name, v in by.items() if "HtoD" in name]
    log(f"  host-to-device copies: {sum(n for _, n in h2d)} taking "
        f"{sum(us for us, _ in h2d) / 1e3:.3f} ms of device time")
    return wall, busy


def profile_phase():
    """Where one engine run's time goes, at full width under
    ``nss_shortcut``: (1) slotted two-phase — 4 slots, each admitted with a
    32-token prompt and then decoded by one 32-token L3 program; (2) path
    B, paged chunked — the same requests entering in chunks of at most 24
    under a budget of 48, then decoded."""
    import dataclasses

    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import ServeEngine, synthetic_requests

    cfg = main_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size, seed=7)
    out = {}
    for label, kw in (
            (f"slotted: {SLOTS} admissions + one {GEN}-step decode program",
             {}),
            (f"paged chunked (path B): {SLOTS} prompts in chunks of "
             f"<= {CHUNK_W}, budget {BUDGET}, then decode",
             dict(kv="paged", block_size=BS, chunked=True,
                  chunk_budget=BUDGET, chunk_width=CHUNK_W))):
        eng = ServeEngine(cfg, params, opts, lk, n_slots=SLOTS,
                          max_len=MAX_LEN, **kw)
        out[label] = _profile_run(label, eng, reqs,
                                  also=("paged_prefill_kernel",
                                        "decode_split"))
    return out


# ---------------------------------------------------------------------------
# the serve step's other modes at full width (tinyllama-1.1b, fp32):
# threefry sampling, slotted chunked prefill, n-gram speculation
# ---------------------------------------------------------------------------

def prng_phase():
    """Threefry on the card against the same computation on the CPU, bit
    for bit: the keys of seeds 0..63, ``fold_in`` of rids 0..7 under each,
    ``split`` of those 512 keys, and 32-bit random bits under them at
    (32000,) and under each seed's key at (4, 32000). The Gumbel noise of
    seeds 0..7 (two ``log``s, which may round differently on the two
    devices) is printed, not gated."""
    import torch
    from repro_torch.core import prng

    def draws(dev):
        seeds = torch.stack([prng.PRNGKey(s, dev) for s in range(64)])
        keys = torch.stack([prng.fold_in(seeds, rid) for rid in range(8)],
                           dim=1)                                # (64, 8, 2)
        return ((seeds, keys, prng.split(keys),
                 prng.random_bits(keys, (32000,)),
                 prng.random_bits(seeds, (4, 32000))),
                prng.gumbel(keys[:8], (32000,)))

    (exact, noise), (exact_c, noise_c) = draws("cuda"), draws("cpu")
    for what, a, b in zip(("PRNGKey", "fold_in", "split",
                           "random_bits (64, 8, 32000)",
                           "random_bits (64, 4, 32000)"), exact, exact_c):
        if not torch.equal(a.cpu(), b):
            bad = (a.cpu() != b).nonzero()[0].tolist()
            raise AssertionError(f"prng: {what} differs between CUDA and "
                                 f"the CPU first at {bad}")
    worst = (noise.cpu() - noise_c).abs().max().item()
    log(f"prng: seeds 0..63 x rids 0..7, keys, fold_in, split and random "
        f"bits at (32000,) and (4, 32000) bit-exact on CUDA vs the CPU; "
        f"Gumbel noise (8 seeds, 8, 32000) max |CUDA - CPU| {worst:.3e} "
        "(not gated)")
    return worst


def _serve(cfg, params, lk, opts, reqs, *, load="open", n_slots=SLOTS,
           **kw):
    """One engine run as ``run_engine`` makes it (a warm request through
    the same programs first, counters reset), launch counts zeroed just
    before the timed run and read just after; every request must finish
    with its budget. Returns (report, streams, launch counts, each
    request's key when it finished)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine, serve_report
    from repro_torch.serve import synthetic_requests
    eng = ServeEngine(cfg, params, opts, lk, n_slots=n_slots,
                      max_len=MAX_LEN, **kw)
    eng.run(synthetic_requests(1, PROMPT, eng.tokens_per_program + 1,
                               cfg.vocab_size, seed=1), load="closed")
    eng.reset_counters()
    keys, finalize = {}, eng._finalize

    def keep_key(slot, now_fn):
        keys[eng.sched.active[slot].req.rid] = eng.kv.keys[slot].clone()
        return finalize(slot, now_fn)
    eng._finalize = keep_key
    ops.reset_launch_counts()
    comps, wall = eng.run(reqs, load=load)
    counts = ops.launch_counts()
    rep = serve_report(comps, wall, eng.utilization())
    want = sum(r.max_new_tokens for r in reqs)
    if rep["requests"] != len(reqs) or rep["total_tokens"] != want:
        raise AssertionError(f"{rep['requests']} requests, "
                             f"{rep['total_tokens']} tokens; want "
                             f"{len(reqs)} x {want // len(reqs)}")
    return rep, {c.rid: c.tokens.tolist() for c in comps}, counts, keys


def _agreement(got, want) -> str:
    agree = sum(int(a == b) for rid in want
                for a, b in zip(got[rid], want[rid]))
    return f"{agree}/{sum(len(w) for w in want.values())} tokens"


def spec_requests(vocab_size, n=REQUESTS):
    """Prompts tiling a random 8-token core 4 times (the JAX tests'
    ``_spec_reqs``), so prompt lookup drafts hit, arriving as the open-load
    requests do (Poisson, 25 requests/s, seed 0)."""
    import numpy as np
    from repro_torch.serve import Request, synthetic_requests
    rng = np.random.default_rng(5)
    arrivals = synthetic_requests(n, PROMPT, GEN, vocab_size, seed=0,
                                  rate=25.0)
    return [Request(rid=r.rid, prompt=np.tile(rng.integers(
        0, vocab_size, SPEC_CORE, dtype=np.int32), PROMPT // SPEC_CORE),
        max_new_tokens=GEN, arrival_s=r.arrival_s) for r in arrivals]


def modes_phase():
    """Paths E, T and S1-S3 at full width, fp32, ``nss_shortcut``, 8
    requests of prompt 32 and gen 32, 4 slots, open load:

    E   slotted chunked prefill (budget 48, chunks of 24): rmsnorm and
        slot decode launch, flash attention never; stream agreement with
        the two-phase slotted run printed.
    T   slotted two-phase sampling (temperature 0.8, top-k 40, seed 7),
        with 4 slots and with 1: each request's last key equals the CPU
        chain split^n(request_key(rid))[0], n the draws its slot made (1
        at admission and K a decode program: the tokens it emitted and
        the draws past its budget in its last program); the two
        schedules' stream agreement printed.
    S1-S3  n-gram speculation of width 4 over programs of 4 decode steps
        (slotted; paged, blocks of 16; paged over int8 pools): drafts
        accepted; S2 launches paged prefill (the verify pass), S3 only
        the fused-dequant paged kernels. Acceptance rate, tokens per
        verify step, tokens/s and the agreement with the plain path
        printed.

    Every request must finish with its budget. Returns the launch counts
    by path."""
    import dataclasses

    import torch
    from repro_torch.core import SamplingConfig, preset, prng
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import synthetic_requests

    cfg = main_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(REQUESTS, PROMPT, GEN, cfg.vocab_size, seed=0,
                              rate=25.0)
    counts = {}

    def report(name, rep, c):
        counts[name] = c
        log(f"serve report (path {name}):", json.dumps(rep))
        log(f"launches (path {name}):", c)

    def launched(name, want=(), never=()):
        for k in want:
            if counts[name].get(k, 0) < 1:
                raise AssertionError(f"path {name}: kernel {k} was never "
                                     "launched")
        for k in never:
            if counts[name].get(k, 0):
                raise AssertionError(f"path {name} launched {k} "
                                     f"{counts[name][k]} times")

    two_phase, two_streams, _, _ = _serve(cfg, params, lk, opts, reqs)
    rep, streams, c, _ = _serve(cfg, params, lk, opts, reqs, chunked=True,
                                chunk_budget=BUDGET, chunk_width=CHUNK_W)
    report("E", rep, c)
    launched("E", ("rmsnorm", "slot_decode"), ("flash_attention",))
    log(f"path E: tokens/s {rep['tokens_per_s']:.6g} (two-phase slotted "
        f"{two_phase['tokens_per_s']:.6g}); stream agreement with the "
        f"two-phase slotted run {_agreement(streams, two_streams)} (not "
        "gated)")

    sc = SamplingConfig(temperature=TEMP, top_k=TOP_K, seed=SAMPLE_SEED)
    draws = 1 + GEN * -(-(GEN - 1) // GEN)    # K = GEN microsteps a program
    chains = {}
    for r in reqs:
        key = sc.request_key(r.rid)
        for _ in range(draws):
            key = prng.split(key)[0]
        chains[r.rid] = key
    sampled = {}
    for name, n_slots in (("T", SLOTS), ("T1", 1)):
        rep, sampled[name], c, keys = _serve(cfg, params, lk, opts, reqs,
                                             n_slots=n_slots, sampling=sc)
        report(name, rep, c)
        for rid, key in chains.items():
            if not torch.equal(keys[rid].cpu(), key):
                raise AssertionError(f"path {name}: request {rid}'s last key "
                                     f"{keys[rid].tolist()} is not the CPU "
                                     f"chain's {key.tolist()}")
        log(f"path {name} ({n_slots} slots): tokens/s "
            f"{rep['tokens_per_s']:.6g}; every request's last key equals "
            f"the CPU chain split^{draws}(request_key(rid))[0]")
    log(f"path T: 4-slot vs 1-slot sampled stream agreement "
        f"{_agreement(sampled['T'], sampled['T1'])}; vs greedy "
        f"{_agreement(sampled['T'], two_streams)} (not gated)")

    lk_s = dataclasses.replace(preset(PRESET), decode_steps=SPEC_K)
    sreqs = spec_requests(cfg.vocab_size)
    unquantized = ("paged_decode", "paged_prefill")
    for name, kw, want, never in (
            ("S1", {}, ("slot_decode", "rmsnorm"), ()),
            ("S2", dict(kv="paged", block_size=BS),
             ("paged_prefill", "paged_decode", "rmsnorm"),
             ("paged_prefill_quant", "paged_decode_quant")),
            ("S3", dict(kv="paged", block_size=BS, kv_dtype="int8"),
             ("paged_prefill_quant", "rmsnorm"), unquantized)):
        _, plain, _, _ = _serve(cfg, params, lk_s, opts, sreqs, **kw)
        rep, got, c, _ = _serve(cfg, params, lk_s, opts, sreqs,
                                spec_decode="ngram", spec_width=SPEC_W, **kw)
        report(name, rep, c)
        launched(name, want, never)
        if rep["spec_steps"] < 1 or rep["spec_accepted_tokens"] < 1:
            raise AssertionError(f"path {name}: {rep['spec_steps']} verify "
                                 f"steps, {rep['spec_accepted_tokens']} "
                                 "accepted drafts")
        log(f"path {name}: verify steps {rep['spec_steps']}, drafts "
            f"{rep['spec_draft_tokens']}, accepted "
            f"{rep['spec_accepted_tokens']}, acceptance rate "
            f"{rep.get('spec_acceptance_rate')}, tokens per verify step "
            f"{rep.get('spec_tokens_per_step')}, tokens/s "
            f"{rep['tokens_per_s']:.6g}; stream agreement with the plain "
            f"path {_agreement(got, plain)} (not gated)")
    del params
    return counts


def verify_teacher_forced_phase(tol: float = 2e-3):
    """The speculative verify pass at full width, kernels against plain
    versions on the card, fed the plain path's tokens: 4 rows at position
    32 after a prefill, each feeding its committed token and 3, 2, 1 or 0
    drafts from the plain path's greedy continuation, over pools filled
    from the plain prefill through a permuted table: the (B, W, V) logits
    of ``serve_verify_step_paged`` within ``tol``, over fp32 pools and
    over int8 pools (there the kernel path replays the plain path's K/V
    writes, ``paged_writes``: an ulp of difference in K can move a code).
    ``build_verify_step``'s emitted counts on both paths are printed."""
    import torch
    from repro_torch.core import build_verify_step, preset
    from repro_torch.launch.mesh_cases import paged_writes
    from repro_torch.models import (ModelOptions, decode_step, init_params,
                                    prefill, serve_verify_step_paged)
    from repro_torch.models.transformer import clone_cache
    from repro_torch.serve.paging import init_paged_cache, scatter_kv

    cfg = main_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    plain = ModelOptions(attn_impl="ref", dtype=torch.float32)
    kern = preset(PRESET).model_options(plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT), generator=g,
                            device="cuda", dtype=torch.int32)
    logits, c0 = prefill(params, prompts, cfg, plain, MAX_LEN)
    cont = [torch.argmax(logits, -1).to(torch.int32)]
    c = clone_cache(c0)
    for _ in range(SPEC_W - 1):
        logits, c = decode_step(params, c, cont[-1], cfg, plain)
        cont.append(torch.argmax(logits, -1).to(torch.int32))
    toks = torch.stack(cont, dim=1)                          # (B, W)
    clen = torch.tensor([4, 3, 2, 1], dtype=torch.int32, device="cuda")
    toks = torch.where(torch.arange(SPEC_W, device="cuda")[None]
                       < clen[:, None], toks, 0)
    start = torch.full((SLOTS,), PROMPT, dtype=torch.int32, device="cuda")
    P = SLOTS * NB + 1
    tables = torch.randperm(P, generator=torch.Generator().manual_seed(2))[
        :SLOTS * NB].reshape(SLOTS, NB).to(torch.int32).cuda()

    def pools(kv_dtype):
        pc = init_paged_cache(cfg, P, BS, SLOTS, torch.float32, "cuda",
                              kv_dtype=kv_dtype)
        p = torch.arange(PROMPT, device="cuda")
        for b in range(SLOTS):
            scatter_kv(pc, [{"k": x["k"][b:b + 1, :PROMPT],
                             "v": x["v"][b:b + 1, :PROMPT]} for x in c0],
                       tables[b, p // BS].long(), p % BS, b, PROMPT)
        return pc

    keys = torch.zeros((SLOTS, 2), dtype=torch.int64, device="cuda")
    vmask = clen > 0
    out = {}
    for kv_dtype in ("bf16", "int8"):
        writes = []
        with paged_writes(writes, replay=False):
            lp, _ = serve_verify_step_paged(params, pools(kv_dtype), toks,
                                            tables, start, clen, cfg, plain,
                                            MAX_LEN)
        with paged_writes(writes, replay=kv_dtype == "int8"):
            lk, _ = serve_verify_step_paged(params, pools(kv_dtype), toks,
                                            tables, start, clen, cfg, kern,
                                            MAX_LEN)
        torch.cuda.synchronize()
        worst = (lp - lk).abs().max().item()
        pools_name = "fp32" if kv_dtype == "bf16" else kv_dtype
        log(f"teacher-forced (paged verify pass, {pools_name} pools, q "
            f"(4,4,32,64), clen 4/3/2/1) max |dlogit|: {worst:.3e} "
            f"(tolerance {tol}; logit scale {lp.abs().max().item():.3g})")
        if not math.isfinite(worst) or worst > tol:
            raise AssertionError(f"teacher-forced verify ({pools_name} "
                                 f"pools) logits differ by {worst}")
        emitted = []
        for opts in (plain, kern):
            fn = build_verify_step(cfg, opts, preset(PRESET), MAX_LEN,
                                   kv_kind="paged")
            _, _, n_emit, _ = fn(params, pools(kv_dtype), toks, clen, start,
                                 vmask, keys, tables)
            emitted.append(n_emit.tolist())
        log(f"build_verify_step ({pools_name} pools) n_emit: plain "
            f"{emitted[0]}, kernels {emitted[1]} (drafts are the plain "
            "path's own; not gated)")
        out[pools_name] = worst
    del params
    return out


def modes_profile_phase():
    """Where the time goes in the new modes, as ``profile_phase`` reads
    it (4 requests of prompt 32 and 33 tokens, a warm run first; the busy
    time from the raw records, ``_profile_run``): the
    slotted two-phase run greedy and sampled (temperature 0.8, top-k 40),
    slotted chunked (path E), and speculation over programs of 4 (paths
    S1-S3, on the tiled-core prompts)."""
    import dataclasses

    import torch
    from repro_torch.core import SamplingConfig, preset
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import ServeEngine, synthetic_requests

    cfg = main_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    lk_s = dataclasses.replace(preset(PRESET), decode_steps=SPEC_K)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size, seed=7)
    sreqs = [dataclasses.replace(r, arrival_s=0.0, max_new_tokens=GEN + 1)
             for r in spec_requests(cfg.vocab_size, SLOTS)]
    sc = SamplingConfig(temperature=TEMP, top_k=TOP_K, seed=SAMPLE_SEED)
    spec = dict(spec_decode="ngram", spec_width=SPEC_W)
    out = {}
    for label, link, rq, kw in (
            ("slotted greedy (the sampled run's control)", lk, reqs, {}),
            (f"slotted sampled (path T): temperature {TEMP}, top-k {TOP_K}",
             lk, reqs, dict(sampling=sc)),
            (f"slotted chunked (path E): chunks of <= {CHUNK_W}, budget "
             f"{BUDGET}", lk, reqs, dict(chunked=True, chunk_budget=BUDGET,
                                         chunk_width=CHUNK_W)),
            (f"spec slotted (path S1): width {SPEC_W}, K {SPEC_K}", lk_s,
             sreqs, spec),
            (f"spec paged (path S2): width {SPEC_W}, K {SPEC_K}", lk_s,
             sreqs, dict(spec, kv="paged", block_size=BS)),
            (f"spec paged int8 (path S3): width {SPEC_W}, K {SPEC_K}",
             lk_s, sreqs, dict(spec, kv="paged", block_size=BS,
                               kv_dtype="int8"))):
        eng = ServeEngine(cfg, params, opts, link, n_slots=SLOTS,
                          max_len=MAX_LEN, **kw)
        out[label] = _profile_run(label, eng, rq)
        if eng.proposer is not None:
            u = eng.utilization()
            log(f"  verify steps {u['spec_steps']} of {eng.programs_run} "
                f"programs, acceptance rate "
                f"{u.get('spec_acceptance_rate')}, tokens per verify step "
                f"{u.get('spec_tokens_per_step')} (the three runs)")
    del params
    return out


# ---------------------------------------------------------------------------
# the host KV tier at full width (tinyllama-1.1b, fp32): swap preemption,
# prefix demotion and promotion, the persistent prefix cache, the TTFT
# budget tuner
# ---------------------------------------------------------------------------

def _tier_serve(cfg, params, lk, opts, reqs, spy=False, load="open", **kw):
    """One engine run as ``run_engine`` makes it (a warm request through
    the same programs, its index blocks shed, counters reset), launch
    counts zeroed just before the timed run (under ``load``) and read just
    after; every request must finish with its budget. With ``spy`` the
    engine records, for each swap preemption, whether the victim was
    mid-prefill. Returns (report, streams, launch counts, engine,
    mid-prefill flags)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine, serve_report
    from repro_torch.serve import synthetic_requests
    eng = ServeEngine(cfg, params, opts, lk, n_slots=SLOTS,
                      max_len=MAX_LEN, **kw)
    eng.run(synthetic_requests(1, PROMPT, eng.tokens_per_program + 1,
                               cfg.vocab_size, seed=1), load="closed")
    eng.kv.drop_prefix_cache()
    eng.reset_counters()
    mid = []
    if spy:
        orig = eng._preempt

        def preempt(slot):
            mid.append(eng.sched.active[slot].prefilling)
            orig(slot)
        eng._preempt = preempt
    ops.reset_launch_counts()
    comps, wall = eng.run(reqs, load=load)
    counts = ops.launch_counts()
    rep = serve_report(comps, wall, eng.utilization())
    want = sum(r.max_new_tokens for r in reqs)
    if rep["requests"] != len(reqs) or rep["total_tokens"] != want:
        raise AssertionError(f"{rep['requests']} requests, "
                             f"{rep['total_tokens']} tokens; want "
                             f"{len(reqs)} x {want // len(reqs)}")
    return (rep, {c.rid: c.tokens.tolist() for c in comps}, counts, eng,
            mid)


TIER_KEYS = ("swap_preemptions", "swap_resumes", "preemptions",
             "kv_swap_out_blocks", "kv_swap_in_blocks", "kv_host_bytes_moved",
             "kv_host_bytes_moved_raw", "kv_bytes_per_block",
             "kv_prefix_demotions", "kv_prefix_promotions",
             "kv_stream_transfers", "kv_prefetch_issued", "kv_prefetch_hits",
             "kv_prefetch_cancels", "kv_swap_fails", "kv_async_swap",
             "kv_host_blocks_total", "kv_host_blocks_hwm", "kv_blocks_hwm",
             "budget_adjustments", "chunk_budget", "prefix_cache_restored")


def tier_phase():
    """Paths W1-W7 at full width, fp32, ``nss_shortcut``, 4 slots, prompt
    32, gen 32, max_len 72, 8 open-load requests sharing path A's 16-token
    prefix (seed 0, 25 requests/s), blocks of 16; W1-W5 over a pool of
    ``TIER_BLOCKS`` (12: four slots of four blocks must preempt; W4 over
    ``TIER_CHUNK_BLOCKS``, 10):

    W1  ``--preempt swap``, async (the side-stream copies, prefetch)
    W2  W1 with ``--sync-swap``
    W3  W1 over int8 blocks
    W4  W1 chunked (budget 48, chunks of 24): a victim swapped mid-prefill
    W5  W1 sampled (temperature 0.8, top-k 40, seed 7)
    W6  a warm start: requests whose 32-token prompts are one shared
        prefix; the cold run saves the prefix cache and a new engine
        restarts from it
    W7  chunked (budget 48, chunks of 24) with a TTFT SLO of 1 ms, which
        no request meets, so the tuner raises the budget

    Gates: the streams of W1 and W2 equal the recompute run under the
    same pool and path A's, W5's the sampled recompute run's; W3's equal
    path C's (against its recompute run they are printed: a recompute
    victim re-admits through a suffix prefill over dequantized blocks);
    W4's the chunked recompute run's and path A's; W2's W1's; W6's
    restart its cold run's; W7's path A's. W1-W5: swap_preemptions >= 1 == swap_resumes; W1: prefetch hits
    >= 1; every byte the tier moved accounted as whole blocks
    (``kv_host_bytes_moved`` == (swapped out + in + demoted + promoted
    blocks) x ``kv_bytes_per_block``); no host block left to a handle
    after the run; the host tensors pinned. W3's blocks >= 1.9x smaller
    than W1's. W6: restored entries and promotions > 0. W7: budget
    adjustments >= 1. Every kernel of each path launched (and no
    unquantized paged kernel on W3, no quantized one elsewhere). Returns
    the launch counts by path."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import SamplingConfig, preset
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import Request, synthetic_requests

    cfg = main_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(REQUESTS, PROMPT, GEN, cfg.vocab_size, seed=0,
                              rate=25.0, shared_prefix_len=SHARED)
    sc = SamplingConfig(temperature=TEMP, top_k=TOP_K, seed=SAMPLE_SEED)
    base = dict(kv="paged", block_size=BS)
    tight = dict(base, num_blocks=TIER_BLOCKS)
    chunk = dict(chunked=True, chunk_budget=BUDGET, chunk_width=CHUNK_W)
    unquantized = ("paged_decode", "paged_prefill")
    quantized = ("paged_decode_quant", "paged_prefill_quant")
    two_phase = ("flash_attention", "paged_decode", "rmsnorm")
    chunked = ("paged_prefill", "paged_decode", "rmsnorm")
    runs, counts = {}, {}

    def serve(name, rq=reqs, spy=False, **kw):
        rep, streams, c, eng, mid = _tier_serve(cfg, params, lk, opts, rq,
                                                spy=spy, **kw)
        runs[name] = (rep, streams, eng, mid)
        counts[name] = c
        log(f"serve report (tier {name}):", json.dumps(rep))
        log(f"launches (tier {name}):", c)
        log(f"tier {name}: " + ", ".join(f"{k} {rep[k]}" for k in TIER_KEYS
                                         if k in rep)
            + f"; tokens/s {rep['tokens_per_s']:.6g}")
        return rep, streams

    def same(name, other, what):
        got, want = runs[name][1], runs[other][1]
        agree = _agreement(got, want)
        log(f"tier {name}: streams vs {what} ({other}): {agree}")
        if got != want:
            raise AssertionError(f"tier {name}: streams differ from "
                                 f"{what} ({other}): {agree}")

    def launched(name, want, never):
        for k in want:
            if counts[name].get(k, 0) < 1:
                raise AssertionError(f"tier {name}: kernel {k} was never "
                                     "launched")
        for k in never:
            if counts[name].get(k, 0):
                raise AssertionError(f"tier {name} launched {k} "
                                     f"{counts[name][k]} times")

    def swapped(name, prefetch_hits=0):
        rep, _, eng, _ = runs[name]
        if rep["swap_preemptions"] < 1:
            raise AssertionError(f"tier {name}: no swap preemption (pool of "
                                 f"{rep['kv_blocks_total']} blocks)")
        if rep["swap_resumes"] != rep["swap_preemptions"]:
            raise AssertionError(f"tier {name}: {rep['swap_resumes']} "
                                 f"resumes of {rep['swap_preemptions']} "
                                 "swaps")
        if rep["kv_prefetch_hits"] < prefetch_hits:
            raise AssertionError(f"tier {name}: {rep['kv_prefetch_hits']} "
                                 "prefetch hits")
        tier(name)

    def tier(name):
        rep, _, eng, _ = runs[name]
        blocks = (rep["kv_swap_out_blocks"] + rep["kv_swap_in_blocks"]
                  + rep["kv_prefix_demotions"] + rep["kv_prefix_promotions"])
        if rep["kv_host_bytes_moved"] != blocks * rep["kv_bytes_per_block"]:
            raise AssertionError(f"tier {name}: {rep['kv_host_bytes_moved']}"
                                 f" bytes moved for {blocks} blocks of "
                                 f"{rep['kv_bytes_per_block']}")
        host = eng.kv.host
        if host.n_resident != len(eng.kv.host_map):
            raise AssertionError(f"tier {name}: {host.n_resident} host "
                                 f"blocks held, {len(eng.kv.host_map)} "
                                 "of them prefixes")
        if not all(t.is_pinned() for t in host.tensors()):
            raise AssertionError(f"tier {name}: host tier not pinned")
        swaps = rep["kv_swap_out_blocks"] + rep["kv_swap_in_blocks"]
        log(f"tier {name}: swap blocks moved {swaps} "
            f"({swaps * rep['kv_bytes_per_block']} bytes), prefix blocks "
            f"{rep['kv_prefix_demotions']} demoted, "
            f"{rep['kv_prefix_promotions']} promoted; host blocks held "
            f"after the run {host.n_resident} (all prefixes), pinned")

    serve("A", **base)
    serve("C", **base, kv_dtype="int8")
    serve("W1r", **tight, preempt="recompute")
    serve("W1", **tight, preempt="swap")
    swapped("W1", prefetch_hits=1)
    launched("W1", two_phase, quantized)
    same("W1", "W1r", "recompute, same pool")
    same("W1", "A", "path A")
    serve("W2", **tight, preempt="swap", async_swap=False)
    swapped("W2")
    launched("W2", two_phase, quantized)
    same("W2", "W1", "async swap")
    same("W2", "W1r", "recompute, same pool")
    serve("W3r", **tight, preempt="recompute", kv_dtype="int8")
    serve("W3", **tight, preempt="swap", kv_dtype="int8")
    swapped("W3")
    launched("W3", ("flash_attention", "paged_decode_quant", "rmsnorm"),
             unquantized)
    same("W3", "C", "path C")
    log(f"tier W3: streams vs recompute, same pool (W3r): "
        f"{_agreement(runs['W3'][1], runs['W3r'][1])} (not gated: a "
        "recompute victim re-admits through a suffix prefill over its "
        "dequantized prompt blocks)")
    ratio = (runs["W1"][0]["kv_bytes_per_block"]
             / runs["W3"][0]["kv_bytes_per_block"])
    log(f"tier W3: bytes per block {runs['W3'][0]['kv_bytes_per_block']}, "
        f"W1's / W3's {ratio:.4f}")
    if ratio < 1.9:
        raise AssertionError(f"tier W3: blocks only {ratio:.3f}x smaller")
    tight4 = dict(base, num_blocks=TIER_CHUNK_BLOCKS)
    serve("W4r", **tight4, **chunk, preempt="recompute")
    serve("W4", spy=True, **tight4, **chunk, preempt="swap")
    swapped("W4")
    launched("W4", chunked, quantized)
    mid = runs["W4"][3]
    log(f"tier W4: swap victims mid-prefill {sum(mid)} of {len(mid)}")
    if not any(mid):
        raise AssertionError("tier W4: no victim was swapped mid-prefill")
    same("W4", "W4r", "chunked recompute, same pool")
    same("W4", "A", "two-phase (path A)")
    serve("W5r", **tight, preempt="recompute", sampling=sc)
    serve("W5", **tight, preempt="swap", sampling=sc)
    swapped("W5")
    launched("W5", two_phase, quantized)
    same("W5", "W5r", "sampled recompute, same pool")
    log(f"tier W5: sampled vs greedy (W1) "
        f"{_agreement(runs['W5'][1], runs['W1'][1])} (not gated)")

    # W6: identical 32-token prompts (one shared prefix), arriving as the
    # open-load requests do
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, cfg.vocab_size, PROMPT, dtype=np.int32)
    w6 = [Request(rid=r.rid, prompt=prefix.copy(), max_new_tokens=GEN,
                  arrival_s=r.arrival_s) for r in reqs]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = os.path.join(tmp, "prefix.npz")
        serve("W6 cold", w6, **base)
        saved = runs["W6 cold"][2].save_prefix_cache(path)
        log(f"tier W6: the cold run saved {saved} entries "
            f"({os.path.getsize(path)} bytes)")
        rep, _ = serve("W6", w6, **base, warm_start=path)
        restored = runs["W6"][2].kv.restored_entries
    log(f"tier W6: restored {restored} entries, promotions "
        f"{rep['kv_prefix_promotions']}, shared tokens "
        f"{rep['kv_prefix_shared_tokens']}")
    if saved < 1 or restored < 1 or rep["kv_prefix_promotions"] < 1:
        raise AssertionError(f"tier W6: saved {saved}, restored {restored},"
                             f" promoted {rep['kv_prefix_promotions']}")
    tier("W6")
    launched("W6", ("paged_decode", "rmsnorm"), quantized)
    same("W6", "W6 cold", "its cold run")

    serve("W7", **base, **chunk, ttft_slo_s=1e-3)
    rep = runs["W7"][0]
    if rep["budget_adjustments"] < 1:
        raise AssertionError("tier W7: the tuner never moved the budget")
    log(f"tier W7: budget {BUDGET} -> {rep['chunk_budget']} after "
        f"{rep['budget_adjustments']} adjustments; p50 TTFT "
        f"{rep['p50_ttft_s']:.6f} s")
    launched("W7", chunked, quantized)
    same("W7", "A", "two-phase (path A)")
    del params
    return {n: counts[n] for n in ("W1", "W2", "W3", "W4", "W5", "W6",
                                   "W7")}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def tier_transfer_phase(reps: int = 7):
    """The tier's transfers at full width (22 layers, HKV 4, dh 64, blocks
    of 16; 720,896 B a block fp32, 180,928 int8): ``swap_out`` + drain and
    ``swap_in`` (plain, and after ``prefetch_swap_in``) of a 5-block and a
    128-block chain, through ``PagedKV`` as the engine calls it. Device
    time (CUDA events): swap-out from before the export to the side
    stream's completion event; swap-in from before the call to after the
    import (the host→device copy waits for the host gather into pinned
    staging, so this spans it), and the copy and import alone from staging
    already gathered. Host time: how long each call blocks the engine.
    Beside them, in the same call, a plain pinned ``copy_`` of the same
    bytes each way (the host link's rate) and a pageable one. Medians of
    ``reps`` rounds after one warm round."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve.paging import BlockTable, PagedKV, import_chain

    cfg = get_config(ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    rows = []
    ev = lambda: torch.cuda.Event(enable_timing=True)   # noqa: E731
    for kvd in ("bf16", "int8"):
        kv = PagedKV(cfg, params, opts, lk, 1, 128 * BS + 8, block_size=BS,
                     num_blocks=130, host_blocks=130, kv_dtype=kvd)
        g = torch.Generator(device="cuda").manual_seed(3)
        for layer in kv.cache:                 # blocks with content
            for name in ("kp", "vp"):
                x = torch.randn(layer[name].shape, generator=g,
                                device="cuda")
                if kvd == "bf16":
                    layer[name].copy_(x)
                else:
                    layer[name].copy_(x.mul(40).round().clamp(-127, 127))
        main = torch.cuda.current_stream()
        for n in (5, 128):
            t = {k: [] for k in ("out_host", "drain_host", "out_dev",
                                 "in_host", "in_dev", "h2d_import_dev",
                                 "pf_host", "pf_in_host", "pf_dev")}
            for r in range(reps + 1):
                blocks = [kv.pool.alloc() for _ in range(n)]
                kv.chains[0] = BlockTable(blocks)
                kv.tables_host[0, :n] = blocks
                kv.pos_host[0] = n * BS
                torch.cuda.synchronize()
                e0 = ev()
                e0.record(main)
                h0 = time.perf_counter()
                handle = kv.swap_out(0)
                h1 = time.perf_counter()
                e1 = ev()                          # after the side copy
                e1.record(kv.stream.side_stream())
                kv.drain_swaps()
                h2 = time.perf_counter()
                # the copy and import alone, from staging gathered before
                staged = kv._read_host(handle.hblks)
                dst = [kv.pool.alloc() for _ in range(n)]
                torch.cuda.synchronize()
                e6, e7 = ev(), ev()
                e6.record(main)
                import_chain(kv.cache, kv._to_device(staged),
                             kv._blk_tensor(dst))
                e7.record(main)
                e7.synchronize()
                for b in dst:
                    kv.pool.free(b)
                e2, e3 = ev(), ev()
                e2.record(main)
                h3 = time.perf_counter()
                kv.swap_in(0, handle)
                h4 = time.perf_counter()
                e3.record(main)
                e3.synchronize()
                kv.release(0)
                # the engine's resume path: prefetch under a device step,
                # then the swap-in that consumes it
                blocks = [kv.pool.alloc() for _ in range(n)]
                kv.chains[0] = BlockTable(blocks)
                kv.pos_host[0] = n * BS
                handle = kv.swap_out(0)
                kv.drain_swaps()
                torch.cuda.synchronize()
                e4, e5 = ev(), ev()
                e4.record(main)
                h5 = time.perf_counter()
                kv.prefetch_swap_in(handle)
                h6 = time.perf_counter()
                kv.swap_in(0, handle)
                h7 = time.perf_counter()
                e5.record(main)
                e5.synchronize()
                kv.release(0)
                if r == 0:
                    continue                   # warm round
                t["out_host"].append((h1 - h0) * 1e3)
                t["drain_host"].append((h2 - h1) * 1e3)
                t["out_dev"].append(e0.elapsed_time(e1))
                t["in_host"].append((h4 - h3) * 1e3)
                t["in_dev"].append(e2.elapsed_time(e3))
                t["h2d_import_dev"].append(e6.elapsed_time(e7))
                t["pf_host"].append((h6 - h5) * 1e3)
                t["pf_in_host"].append((h7 - h6) * 1e3)
                t["pf_dev"].append(e4.elapsed_time(e5))
            nbytes = n * kv._block_bytes
            dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
            pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            pageable = torch.empty(nbytes, dtype=torch.uint8)
            copies = {}
            for label, dst, src in (("d2h pinned", pinned, dev),
                                    ("h2d pinned", dev, pinned),
                                    ("d2h pageable", pageable, dev),
                                    ("h2d pageable", dev, pageable)):
                ms = []
                for r in range(reps + 1):
                    torch.cuda.synchronize()
                    a, b = ev(), ev()
                    a.record(main)
                    dst.copy_(src, non_blocking=True)
                    b.record(main)
                    b.synchronize()
                    if r:
                        ms.append(a.elapsed_time(b))
                copies[label] = _median(ms)
            row = {"kv_dtype": kvd, "blocks": n, "bytes": nbytes,
                   **{k: _median(v) for k, v in t.items()},
                   **{f"copy {k}": v for k, v in copies.items()}}
            rows.append(row)
            gbs = lambda ms: nbytes / ms / 1e6          # noqa: E731
            log(f"tier transfer {kvd} {n} blocks ({nbytes} B): swap_out "
                f"host {row['out_host']:.4f} ms + drain "
                f"{row['drain_host']:.4f} ms, device "
                f"{row['out_dev']:.4f} ms ({gbs(row['out_dev']):.2f} GB/s);"
                f" swap_in host {row['in_host']:.4f} ms, device "
                f"{row['in_dev']:.4f} ms ({gbs(row['in_dev']):.2f} GB/s), "
                f"of which the copy and import "
                f"{row['h2d_import_dev']:.4f} ms "
                f"({gbs(row['h2d_import_dev']):.2f} GB/s); "
                f"prefetch host {row['pf_host']:.4f} ms + swap_in (hit) "
                f"{row['pf_in_host']:.4f} ms, device {row['pf_dev']:.4f} "
                "ms; plain copy_ d2h pinned "
                f"{copies['d2h pinned']:.4f} ms "
                f"({gbs(copies['d2h pinned']):.2f} GB/s), h2d pinned "
                f"{copies['h2d pinned']:.4f} ms "
                f"({gbs(copies['h2d pinned']):.2f} GB/s), d2h pageable "
                f"{copies['d2h pageable']:.4f} ms "
                f"({gbs(copies['d2h pageable']):.2f} GB/s), h2d pageable "
                f"{copies['h2d pageable']:.4f} ms "
                f"({gbs(copies['h2d pageable']):.2f} GB/s)")
            del dev, pinned, pageable
        del kv
    log("tier transfers:", json.dumps(rows))
    del params
    return rows


def tier_profile_phase():
    """M1: where W1's time goes against recompute under the same pool, in
    one call — 8 requests of prompt 32 (a shared 16-token prefix) and 33
    tokens, closed load, a pool of ``TIER_BLOCKS`` blocks: wall
    (unprofiled), device busy (raw CUDA records) and idle share of each
    (``_profile_run``: warm, timed, profiled) and the tier counters
    of the three runs."""
    import dataclasses

    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import ServeEngine, synthetic_requests

    cfg = main_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(REQUESTS, PROMPT, GEN + 1, cfg.vocab_size,
                              seed=7, shared_prefix_len=SHARED)
    out = {}
    for mode in ("recompute", "swap"):
        label = (f"tier W1 ({mode}): {REQUESTS} requests, pool of "
                 f"{TIER_BLOCKS} blocks")
        eng = ServeEngine(cfg, params, opts, lk, n_slots=SLOTS,
                          max_len=MAX_LEN, kv="paged", block_size=BS,
                          num_blocks=TIER_BLOCKS, preempt=mode)
        out[mode] = _profile_run(label, eng, reqs)
        u = eng.utilization()
        log(f"  {mode}: " + ", ".join(f"{k} {u[k]}" for k in TIER_KEYS
                                      if k in u) + " (the three runs)")
    del params
    return out


# ---------------------------------------------------------------------------
# the engine fleet (tinyllama-1.1b at full width, fp32): the replica router,
# prefill/decode disaggregation over the host tier, the shared prefix store
# ---------------------------------------------------------------------------

FLEET_KEYS = ("fleet_handoffs", "handoffs_out", "handoffs_in",
              "fleet_pending_handoffs", "kv_prefix_publishes",
              "kv_prefix_promotions", "shared_store_entries",
              "shared_store_cross_hits", "shared_store_blocks",
              "kv_host_bytes_moved", "kv_bytes_per_block", "prefill_tokens",
              "decode_tokens", "programs_run")


def _fleet_serve(cfg, params, lk, opts, reqs, load="open", probe=None, **kw):
    """One fleet run as ``run_fleet_engine`` makes it (a warm request a
    replica through the same programs, the prefix residue shed on every
    replica and in the shared store, counters reset), ``probe(fleet)``
    installed, launch counts zeroed just before the timed run (under
    ``load``) and read just after; every request must finish with its
    budget. Returns (report, streams, launch counts, fleet)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (FleetEngine, fleet_report,
                                   synthetic_requests)
    fleet = FleetEngine(cfg, params, opts, lk, n_slots=SLOTS,
                        max_len=MAX_LEN, kv="paged", block_size=BS, **kw)
    fleet.run(synthetic_requests(fleet.replicas, PROMPT,
                                 fleet.engines[0].tokens_per_program + 1,
                                 cfg.vocab_size, seed=1), load="closed")
    fleet.drop_prefix_cache()
    fleet.reset_counters()
    if probe is not None:
        probe(fleet)
    ops.reset_launch_counts()
    comps, wall = fleet.run(reqs, load=load)
    counts = ops.launch_counts()
    rep = fleet_report(comps, wall, fleet)
    want = sum(r.max_new_tokens for r in reqs)
    if rep["requests"] != len(reqs) or rep["total_tokens"] != want:
        raise AssertionError(f"{rep['requests']} requests, "
                             f"{rep['total_tokens']} tokens; want "
                             f"{len(reqs)} x {want // len(reqs)}")
    return rep, {c.rid: c.tokens.tolist() for c in comps}, counts, fleet


def _tree_bytes(tree) -> int:
    """Bytes of the tensors in a nest of dicts and lists."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


def _handoff_probe(rows):
    """Instrument a disaggregated fleet of two: per handoff its blocks and
    bytes, the host ms of the prefill cell's ``extract_handoffs`` (the
    call's time over the handoffs it returned) and of the decode cell's
    ``inject_handoff``, and the swap-in's time on CUDA events on the
    current stream, from before the call to after the import (the copy
    waits for the host gather into pinned staging, so this spans it, as
    ``tier_transfer_phase``'s swap-in device time does)."""
    import torch

    def probe(fleet):
        pre, dec = fleet.engines
        extract, inject = pre.extract_handoffs, dec.inject_handoff
        swap_in = dec.kv.swap_in
        per = []                          # extract ms per handoff, FIFO

        def timed_extract():
            h0 = time.perf_counter()
            out = extract()
            ms = (time.perf_counter() - h0) * 1e3
            per.extend([ms / max(1, len(out))] * len(out))
            return out

        def timed_swap_in(slot, handle):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            ok = swap_in(slot, handle)
            e1.record()
            rows[-1]["events"] = (e0, e1)
            return ok

        def timed_inject(st, handle, nxt):
            n = len(handle.hblks)
            rows.append({"rid": st.req.rid, "blocks": n,
                         "bytes": n * pre.kv._block_bytes,
                         "extract_ms": per[len(rows)]})
            h0 = time.perf_counter()
            ok = inject(st, handle, nxt)
            rows[-1]["inject_ms"] = (time.perf_counter() - h0) * 1e3
            return ok
        pre.extract_handoffs = timed_extract
        dec.inject_handoff = timed_inject
        dec.kv.swap_in = timed_swap_in
    return probe


def _stream_wait_probe(fleet, rec):
    """Replace a colocated fleet's tick by one that records, for each
    commit of a replica but the last while the last has a program in
    flight: whether the commit finished a request (under ``ret_async`` its
    only sync, the device→host copy of the finished tokens, queued on the
    one stream behind the last replica's program), whether that program
    had already ended when the commit began, and the commit's host ms."""
    import torch

    def tick(now_fn):
        tickets, ends = [], []
        for eng in fleet.engines:
            tickets.append(eng.tick_dispatch(now_fn))
            ends.append(torch.cuda.Event())
            ends[-1].record()
        finished = []
        for i, eng in enumerate(fleet.engines):
            ended = ends[-1].query()
            h0 = time.perf_counter()
            done = eng.tick_commit(tickets[i], now_fn)
            ms = (time.perf_counter() - h0) * 1e3
            if i + 1 < len(ends) and tickets[-1][1] is not None:
                rec.append((bool(done), ended, ms))
            finished += done
        return finished
    fleet._tick_all = tick


def fleet_phase(base=None):
    """The fleet (``FleetEngine``) at full width, fp32, ``nss_shortcut``, 4
    slots a replica, prompt 32, gen 32, max_len 72, blocks of 16, 8
    requests sharing path A's 16-token prefix (open load at 25 requests/s
    unless said): every replica over ONE copy of the weights and one
    shared host tier (``replicas`` x 21 blocks, pinned), all on the
    current CUDA stream.

    FL1  1 replica, paged two-phase, closed load: the streams of path A
         and every utilization key shared with the bare engine's own
         closed-load run equal.
    FL2  2 replicas, 1 prefill cell (chunked) and 1 decode cell: the
         streams of path A; 8 handoffs == handoffs_out == handoffs_in;
         the prefill cell decodes nothing (no decode program, decode
         tokens 0) and the decode cell prefills nothing; paged_prefill
         and paged_decode launch, flash never.
    FL3  FL2 over int8 blocks: the streams of the colocated int8 engine
         that prefills as the prefill cell does (chunked, budget 256); its
         agreement with path C (two-phase int8) printed; 8 handoffs;
         blocks >= 3.9x smaller than FL2's; only the fused-dequant paged
         kernels launch.
    FL4  2 colocated replicas over the shared store, closed load (every
         request routed at once, so both replicas admit): the streams of
         path A; publishes > 0, cross-replica hits > 0; after
         ``drop_prefix_cache`` the shared map is empty.
    FL5  the launcher: ``run_fleet_engine(replicas=4, disaggregate=2,
         load="open", smoke=False)`` with a Chrome trace: every request
         finishes, handoffs == requests, the trace validates with process
         tracks engine/0-engine/3 and 8 ``handoff`` events, every replica
         holds the same weight tensors, and the peak device memory above
         its start exceeds FL1's by less than 1 GB (three more pools, not a
         copy of the 4.4 GB of weights).

    Then FL2's handoff cost (``_handoff_probe``, medians), the profile of
    the bare engine, 2 colocated replicas and FL2 in one call (M1;
    closed load, 4 requests of 33 tokens, ``_profile_run``), and whether one
    replica's sync waits for the next replica's program on the shared
    stream (``_stream_wait_probe``, 2 colocated replicas over programs of
    8 steps). ``base`` is {"A": streams, "C": streams} of ``path_phase``;
    without it (``chip_smoke.py fleet``) paths A and C are served here.
    Returns the launch counts by path."""
    import dataclasses
    import tempfile

    import torch
    import repro_torch.serve as rs
    from repro_torch.core import preset
    from repro_torch.launch.fleet import run_fleet_engine
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import ServeEngine, synthetic_requests
    from repro_torch.serve.telemetry import load_trace, validate_events

    t_start = time.time()
    cfg = main_config()
    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(REQUESTS, PROMPT, GEN, cfg.vocab_size, seed=0,
                              rate=25.0, shared_prefix_len=SHARED)
    unquantized = ("paged_decode", "paged_prefill")
    quantized = ("paged_decode_quant", "paged_prefill_quant")
    counts = {}

    def launched(name, want, never):
        for k in want:
            if counts[name].get(k, 0) < 1:
                raise AssertionError(f"fleet {name}: kernel {k} was never "
                                     "launched")
        for k in never:
            if counts[name].get(k, 0):
                raise AssertionError(f"fleet {name} launched {k} "
                                     f"{counts[name][k]} times")

    def same(name, got, want, what):
        agree = _agreement(got, want)
        log(f"fleet {name}: streams vs {what}: {agree}")
        if got != want:
            raise AssertionError(f"fleet {name}: streams differ from "
                                 f"{what}: {agree}")

    def report(name, rep):
        log(f"serve report (fleet {name}):", json.dumps(
            {k: v for k, v in rep.items() if k != "per_replica"}))
        log(f"launches (fleet {name}):", counts[name])
        log(f"fleet {name}: " + ", ".join(f"{k} {rep[k]}" for k in
                                          FLEET_KEYS if k in rep)
            + f"; tokens/s {rep['tokens_per_s']:.6g}")

    def handed(name, rep):
        if not (rep["fleet_handoffs"] == rep["handoffs_out"]
                == rep["handoffs_in"] == REQUESTS):
            raise AssertionError(
                f"fleet {name}: handoffs {rep['fleet_handoffs']}, out "
                f"{rep['handoffs_out']}, in {rep['handoffs_in']}; want "
                f"{REQUESTS}")

    # FL5 first, on its own weights (the launcher makes them), so that its
    # peak memory and FL1's each count one copy of the weights
    _release()
    made = []

    class Spy(rs.FleetEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    orig_fleet = rs.FleetEngine
    rs.FleetEngine = Spy
    from repro_torch.kernels import ops
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            path = str(Path(tmp) / "fleet.json")
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            ops.reset_launch_counts()
            rep5 = run_fleet_engine(main_config(), PRESET, replicas=4,
                                    disaggregate=2, n_slots=SLOTS,
                                    prompt_len=PROMPT, gen_len=GEN,
                                    requests=REQUESTS,
                                    load="open", smoke=False, device="cuda",
                                    block_size=BS, shared_prefix_len=SHARED,
                                    trace=path)
            counts["FL5"] = ops.launch_counts()
            peak5 = torch.cuda.max_memory_allocated() - m0
            events = load_trace(path)
            with open(path) as f:
                lanes = sorted(e["args"]["name"] for e in
                               json.load(f)["traceEvents"] if e["ph"] == "M")
    finally:
        rs.FleetEngine = orig_fleet
    report("FL5", rep5)
    if rep5["requests"] != REQUESTS or rep5["total_tokens"] != REQUESTS * GEN:
        raise AssertionError(f"fleet FL5: {rep5['requests']} requests, "
                             f"{rep5['total_tokens']} tokens")
    handed("FL5", rep5)
    validate_events(events)
    n_hand = sum(e["type"] == "handoff" for e in events)
    log(f"fleet FL5: trace of {len(events)} events, process tracks {lanes},"
        f" {n_hand} handoff events")
    if lanes != [f"engine/{i}" for i in range(4)] + ["requests"]:
        raise AssertionError(f"fleet FL5: trace tracks {lanes}")
    if n_hand != REQUESTS:
        raise AssertionError(f"fleet FL5: {n_hand} handoff events")
    fleet5 = made[0]
    ptrs = {p for e in fleet5.engines
            for p in (e.params["embed"].data_ptr(),
                      e.kv.params["embed"].data_ptr())}
    weights = _tree_bytes(fleet5.engines[0].params)
    store = fleet5.shared.store.tensors()
    log(f"fleet FL5: {len(fleet5.engines)} replicas over {len(ptrs)} "
        f"embedding tensor(s), {weights} B of weights; shared store "
        f"{fleet5.shared.store.num_blocks} blocks ({_tree_bytes(store)} B),"
        f" pinned {all(t.is_pinned() for t in store)}")
    if len(ptrs) != 1:
        raise AssertionError("fleet FL5: the replicas hold different "
                             "weight tensors")
    launched("FL5", ("paged_prefill", "paged_decode", "rmsnorm"),
             ("flash_attention",) + quantized)
    del made, fleet5, Spy
    _release()
    log(f"fleet FL1-FL5 timing: FL5 done at {time.time() - t_start:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if base is None:
        base = {name: _tier_serve(cfg, params, lk, opts, reqs, kv="paged",
                                  block_size=BS, **kw)[1]
                for name, kw in (("A", {}), ("C", dict(kv_dtype="int8")))}
    a_streams, c_streams = base["A"], base["C"]

    rep1, s1, counts["FL1"], f1 = _fleet_serve(cfg, params, lk, opts, reqs,
                                               load="closed", replicas=1)
    peak1 = torch.cuda.max_memory_allocated() - m0
    report("FL1", rep1)
    same("FL1", s1, a_streams, "path A")
    bare_rep, bare_s, _, _, _ = _tier_serve(cfg, params, lk, opts, reqs,
                                            load="closed", kv="paged",
                                            block_size=BS)
    same("FL1", s1, bare_s, "the bare engine, closed load")
    u1 = f1.engines[0].utilization()
    keys = sorted(set(u1) & set(bare_rep))
    diff = {k: (u1[k], bare_rep[k]) for k in keys if u1[k] != bare_rep[k]}
    log(f"fleet FL1: {len(keys)} utilization keys shared with the bare "
        f"engine, differing {diff}")
    if diff:
        raise AssertionError(f"fleet FL1: utilization differs {diff}")
    launched("FL1", ("flash_attention", "paged_decode", "rmsnorm"),
             quantized)
    log(f"fleet FL5 vs FL1 peak device memory above the start: "
        f"{peak5} vs {peak1} B (difference {peak5 - peak1} B; one pool "
        f"{f1.engines[0].utilization()['kv_bytes_per_shard']} B, the "
        f"weights {weights} B)")
    if peak5 - peak1 > 1e9:
        raise AssertionError(f"fleet FL5: {peak5 - peak1} B more device "
                             "memory than FL1")
    del f1

    hand_rows = []
    decodes = []

    def fl2_probe(fleet):
        _handoff_probe(hand_rows)(fleet)
        kv = fleet.engines[0].kv
        dec = kv.decode
        kv.decode = lambda nxt: decodes.append(1) or dec(nxt)
    rep2, s2, counts["FL2"], f2 = _fleet_serve(
        cfg, params, lk, opts, reqs, probe=fl2_probe, replicas=2,
        prefill_replicas=1)
    report("FL2", rep2)
    same("FL2", s2, a_streams, "path A")
    handed("FL2", rep2)
    pre, dec = rep2["per_replica"]
    log(f"fleet FL2: prefill cell decode tokens {pre['decode_tokens']}, "
        f"decode programs {len(decodes)}, programs {pre['programs_run']}; "
        f"decode cell prefill tokens {dec['prefill_tokens']}, programs "
        f"{dec['programs_run']}")
    if pre["decode_tokens"] or decodes or dec["prefill_tokens"]:
        raise AssertionError("fleet FL2: the prefill cell decoded or the "
                             "decode cell prefilled")
    launched("FL2", ("paged_prefill", "paged_decode", "rmsnorm"),
             ("flash_attention",) + quantized)
    torch.cuda.synchronize()
    for r in hand_rows:
        e0, e1 = r.pop("events")
        r["swap_in_ms"] = e0.elapsed_time(e1)
    cost = {k: _median([r[k] for r in hand_rows])
            for k in ("blocks", "bytes", "extract_ms", "inject_ms",
                      "swap_in_ms")}
    log(f"fleet FL2 handoffs ({len(hand_rows)}):", json.dumps(hand_rows))
    log("fleet FL2 handoff cost (medians):", json.dumps(cost))
    del f2

    rep3, s3, counts["FL3"], f3 = _fleet_serve(
        cfg, params, lk, opts, reqs, replicas=2, prefill_replicas=1,
        kv_dtype="int8")
    report("FL3", rep3)
    handed("FL3", rep3)
    _, c_chunked, _, _, _ = _tier_serve(cfg, params, lk, opts, reqs,
                                        kv="paged", block_size=BS,
                                        kv_dtype="int8", chunked=True)
    same("FL3", s3, c_chunked, "the colocated chunked int8 engine")
    log(f"fleet FL3: streams vs path C (two-phase int8): "
        f"{_agreement(s3, c_streams)} (not gated: a chunk attends its own "
        "freshly written codes)")
    ratio = rep2["kv_bytes_per_block"] / rep3["kv_bytes_per_block"]
    log(f"fleet FL3: bytes per block {rep3['kv_bytes_per_block']}, FL2's / "
        f"FL3's {ratio:.4f}; tier bytes moved {rep3['kv_host_bytes_moved']}"
        f" vs FL2's {rep2['kv_host_bytes_moved']}")
    if ratio < 3.9:
        raise AssertionError(f"fleet FL3: blocks only {ratio:.3f}x smaller")
    launched("FL3", ("paged_prefill_quant", "paged_decode_quant", "rmsnorm"),
             ("flash_attention",) + unquantized)
    del f3

    rep4, s4, counts["FL4"], f4 = _fleet_serve(cfg, params, lk, opts, reqs,
                                               load="closed", replicas=2)
    report("FL4", rep4)
    same("FL4", s4, a_streams, "path A")
    if rep4["kv_prefix_publishes"] < 1 or rep4["shared_store_cross_hits"] < 1:
        raise AssertionError(f"fleet FL4: publishes "
                             f"{rep4['kv_prefix_publishes']}, cross hits "
                             f"{rep4['shared_store_cross_hits']}")
    f4.drop_prefix_cache()
    left = f4.utilization()["shared_store_entries"]
    log(f"fleet FL4: shared store entries after drop_prefix_cache {left}")
    if left:
        raise AssertionError(f"fleet FL4: {left} shared entries left")
    launched("FL4", ("flash_attention", "paged_decode", "rmsnorm"),
             quantized)
    del f4
    log(f"fleet FL1-FL5 timing: FL1-FL4 done at {time.time() - t_start:.1f}"
        " s")

    # M1: the bare engine, 2 colocated replicas and FL2, in one call, on
    # one wave of requests (a slot each on the bare engine)
    preqs = synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size,
                               seed=7, shared_prefix_len=SHARED)
    kw = dict(n_slots=SLOTS, max_len=MAX_LEN, kv="paged", block_size=BS)
    prof = {}
    for label, eng in (
            ("bare engine", ServeEngine(cfg, params, opts, lk, **kw)),
            ("2 colocated replicas",
             rs.FleetEngine(cfg, params, opts, lk, replicas=2, **kw)),
            ("FL2: 1 prefill + 1 decode cell",
             rs.FleetEngine(cfg, params, opts, lk, replicas=2,
                            prefill_replicas=1, **kw))):
        prof[label] = _profile_run(f"fleet, {label}", eng, preqs,
                                   also=("paged_prefill_kernel",
                                         "decode_split"))
        del eng
    # one stream: programs of 8 steps, so a request spans 4 of them and
    # only the last commit of each syncs
    colocated = rs.FleetEngine(cfg, params, opts,
                               dataclasses.replace(lk, decode_steps=8),
                               replicas=2, **kw)
    rec = []
    _stream_wait_probe(colocated, rec)
    colocated.run(preqs, load="closed")
    for synced in (True, False):
        rows = [r for r in rec if r[0] == synced]
        log(f"fleet stream wait (2 colocated, K 8, closed): replica 0's "
            f"commits {'with' if synced else 'without'} a sync "
            f"{len(rows)}; replica 1's program already ended as the commit "
            f"began in {sum(r[1] for r in rows)}; commit host ms "
            f"{[round(r[2], 3) for r in rows]}")
    del colocated, params
    log(f"fleet FL1-FL5 timing: phase done at {time.time() - t_start:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# the MoE path: full-width, full-depth moonshot-v1-16b-a3b in bf16
# ---------------------------------------------------------------------------

# the mesh phase: tinyllama-1.1b at full width over 1x2 (tensor parallel)
# and 2x1 (slots over data), both ranks of each on the one card over gloo
MESH_PATHS = {"1,2": ("slotted", "A", "C"), "2,1": ("slotted", "A")}
#: the mesh phase's int8 teacher-forced case without the replayed writes
#: (``flip`` against the unsharded run, ``fmt`` against its fp32 pools)
FLIP_CASE = "paged int8, own writes"


def _mesh_rank(mesh, paths, teacher):
    """One rank of ``mesh_phase`` (``spawn``'s entry, in a process of its
    own): each path through ``serve_rank`` (``run_engine`` over this rank's
    shard), then the teacher-forced cases (``mesh_cases``)."""
    from repro_torch.launch import mesh_cases
    from repro_torch.launch.serve import serve_rank
    out = {"paths": {}, "teacher": {}, "backend": mesh.backend,
           "device": str(mesh.device)}
    for name, kw in paths:
        t = time.time()
        with last_streams({}) as got:
            res = serve_rank(mesh, kw)
        out["paths"][name] = dict(res, streams=got["streams"],
                                  seconds=time.time() - t)
    for case in teacher:
        out["teacher"][case["name"]] = mesh_cases.run_case(case, mesh,
                                                           smoke=False)
    return out


def _over(mesh, spec):
    """``mesh`` itself for a 1x2 spec, else a ``spec`` mesh over the same
    live world, built by every rank in the same order (one spawn serves
    both shapes: a rank process starts once)."""
    from repro_torch.launch.mesh import make_host_mesh, parse_mesh_spec
    if spec == "1,2":
        return mesh
    return make_host_mesh(*parse_mesh_spec(spec), device=mesh.device)


def _mesh_ranks(mesh, jobs):
    """One rank of ``mesh_phase``'s spawn: for each (spec, paths,
    teacher), ``_mesh_rank`` over that mesh shape of the world."""
    return {spec: _mesh_rank(_over(mesh, spec), paths, teacher)
            for spec, paths, teacher in jobs}


def mesh_phase(base=None, tol: float = 2e-3):
    """Serving over a (data, model) mesh, full-width tinyllama-1.1b in fp32,
    ``nss_shortcut``, the main paths' traffic (4 slots, prompt 32, gen 32,
    max_len 72, 8 open-load requests). One spawn
    (``repro_torch.launch.mesh.spawn``) whose two ranks run the 1x2 mesh,
    then the 2x1 mesh over the same world, both on the one card over
    gloo: two ranks sharing a card measure correctness, not tensor-parallel
    speed.

    1x2  Megatron tensor parallelism (HQ 16, HKV 2 a rank): the slotted
         path, paged path A and paged path C (int8 blocks) through
         ``run_engine``, the streams equal to the unsharded paths'; the
         teacher-forced kernel path (prefill, 8 decode steps slotted and
         paged, a 16-token paged chunk pass) within ``tol`` of the
         unsharded kernel path on every rank, over fp32 pools and over
         int8 pools (there each rank replays its heads of the unsharded
         run's K/V writes, so its codes and (L, HKV_local) scales are the
         unsharded pool's heads: a code moves a whole step on an ulp).
         Path C's streams may part where two logits nearly tie: each rank
         writes codes from K/V that differ from the unsharded run's by
         fp32 ulps (the model axis sums its partials in another order),
         and a code moves a whole step on an ulp. So at each request's
         first differing token the unsharded kernel path, teacher-forced
         over the request's prompt and the common history, must hold the
         two tokens' logits within twice ``fmt``, the largest |dlogit|
         between its int8 and fp32 pools on the teacher-forced case: the
         teacher path reads the prompt's K/V as the engine's does not
         (the engine's later admissions read the shared prefix's codes),
         a difference of the int8 format's size. Printed beside it:
         ``flip``, the largest |dlogit| between the 1x2 and unsharded
         kernel paths over int8 pools that each write their own K/V.
    2x1  slots over the data axis: the slotted path (2 slot rows a rank)
         and paged path A (the pools replicated, as JAX's spec has them):
         the streams equal the unsharded paths'.

    Gated on every rank: every request finished, every kernel of its path
    launched (and no paged kernel of the other storage type), the KV bytes
    per shard half the unsharded path's where the heads or the slot rows
    split (equal for 2x1 paged). Printed: tokens/s, per-rank peak memory,
    seconds. ``base`` maps "slotted", "A", "C" to (report, streams) of the
    path phase; without it (``chip_smoke.py mesh``) they are served here.
    Returns the launch counts by (mesh, path, rank)."""
    import numpy as np
    import torch
    from repro_torch.launch import mesh_cases
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import run_engine
    from repro_torch.serve import synthetic_requests

    t_start = time.time()
    common = dict(n_slots=SLOTS, prompt_len=PROMPT, gen_len=GEN,
                  requests=REQUESTS, load="open", smoke=False, device="cuda")
    path_kw = {"slotted": {},
               "A": dict(kv="paged", block_size=BS,
                         shared_prefix_len=SHARED),
               "C": dict(kv="paged", block_size=BS, shared_prefix_len=SHARED,
                         kv_dtype="int8")}
    unquantized = ("paged_decode", "paged_prefill")
    quantized = ("paged_decode_quant", "paged_prefill_quant")
    want = {"slotted": ("rmsnorm", "flash_attention", "slot_decode"),
            "A": ("paged_decode", "flash_attention", "rmsnorm"),
            "C": ("paged_decode_quant", "flash_attention", "rmsnorm")}
    never = {"slotted": unquantized + quantized, "A": quantized,
             "C": unquantized}
    if base is None:
        base = {}
        for name, kw in path_kw.items():
            with last_streams({}) as out:
                rep = run_engine(main_config(), PRESET, **common, **kw)
            base[name] = (rep, out["streams"])
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 32000, PROMPT).tolist()
    feed = rng.integers(0, 32000, 8).tolist()
    # the int8 case records the unsharded run's K/V writes and the ranks
    # replay their heads of them (``mesh_cases.paged_writes``): the pools
    # then hold the same codes and per-(block, head) scales, and only the
    # arithmetic differs, as in ``teacher_forced_phase``
    # FLIP_CASE (no replay) measures ``flip`` and ``fmt`` (docstring)
    teacher, ref = [], {}
    for n, b, kvd in (("slotted", "slotted", "bf16"),
                      ("paged", "paged", "bf16"),
                      ("paged int8", "paged", "int8"),
                      (FLIP_CASE, "paged", "int8")):
        c = dict(name=n, kind="teacher", preset=PRESET, prompt=prompt,
                 overrides=(("num_blocks", MAIN_BLOCKS),),
                 feed=feed, backend=b, max_len=MAX_LEN, block_size=BS,
                 kv_dtype=kvd)
        if n == "paged int8":
            c["kv_writes"] = "record"
        res = mesh_cases.run_case(c, None, smoke=False, device="cuda")
        ref[n] = res["logits"]
        teacher.append(dict(c, kv_writes=res["kv_writes"])
                       if "kv_writes" in res else c)
    mesh_cases._MODELS.clear()
    _release()
    fmt = float(np.abs(ref[FLIP_CASE] - ref["paged"]).max())
    log(f"mesh: unsharded references done at {time.time() - t_start:.1f} s;"
        f" int8 against fp32 pools (fmt): max |dlogit| {fmt:.3e}")
    reqs = synthetic_requests(REQUESTS, PROMPT, GEN, main_config().vocab_size,
                              seed=0, rate=25.0, shared_prefix_len=SHARED)
    prompts_c = {r.rid: r.prompt.tolist() for r in reqs}

    def tie_logits(prompt, history):
        # path C's near ties: the unsharded kernel path over int8 pools
        case = dict(name="tie", kind="teacher", preset=PRESET, prompt=prompt,
                    feed=history, backend="paged", kv_dtype="int8",
                    max_len=MAX_LEN, block_size=BS,
                    overrides=(("num_blocks", MAIN_BLOCKS),))
        return mesh_cases.run_case(case, None, smoke=False,
                                   device="cuda")["logits"][len(history)]

    counts = {}
    t0 = time.time()
    jobs = [(spec, [(n, dict(arch=main_config(), preset_name=PRESET,
                             **common, **path_kw[n])) for n in names],
             teacher if spec == "1,2" else [])
            for spec, names in MESH_PATHS.items()]
    spawned = spawn(_mesh_ranks, "1,2", "cuda", (jobs,), deadline_s=600)
    log(f"mesh: one spawn of 2 ranks for {', '.join(MESH_PATHS)}, "
        f"{time.time() - t0:.1f} s")
    for spec, names in MESH_PATHS.items():
        mname = spec.replace(",", "x")
        ranks = [r[spec] for r in spawned]
        log(f"mesh {mname}: {len(ranks)} ranks, backend "
            f"{ranks[0]['backend']}, devices "
            f"{[r['device'] for r in ranks]}")
        flip = None
        for name in ranks[0]["teacher"]:
            worst = max(float(np.abs(rank["teacher"][name]["logits"]
                                     - ref[name]).max()) for rank in ranks)
            if name == FLIP_CASE:
                flip = worst
                log(f"mesh {mname} teacher-forced ({name}: each path writing "
                    f"its own K/V) vs unsharded: max |dlogit| {worst:.3e} "
                    "(flip, not gated)")
                continue
            log(f"mesh {mname} teacher-forced ({name}, kernels, prefill + 8 "
                f"decode steps + a chunk pass"
                + (", the unsharded K/V writes replayed" if "int8" in name
                   else "")
                + f") vs unsharded: max |dlogit| {worst:.3e} (tolerance "
                f"{tol})")
            if not worst <= tol:
                raise AssertionError(f"mesh {mname} teacher-forced {name}: "
                                     f"logits differ by {worst}")
        for n in names:
            base_rep, base_streams = base[n]
            for r, rank in enumerate(ranks):
                got = rank["paths"][n]
                rep = got["report"]
                c = counts[f"{mname} {n} rank {r}"] = got["launches"]
                if (rep["requests"] != REQUESTS
                        or rep["total_tokens"] != REQUESTS * GEN):
                    raise AssertionError(
                        f"mesh {mname} {n} rank {r}: {rep['requests']} "
                        f"requests, {rep['total_tokens']} tokens")
                for k in want[n]:
                    if c.get(k, 0) < 1:
                        raise AssertionError(f"mesh {mname} {n} rank {r}: "
                                             f"kernel {k} never launched")
                for k in never[n]:
                    if c.get(k, 0):
                        raise AssertionError(f"mesh {mname} {n} rank {r} "
                                             f"launched {k}")
                ratio = rep["kv_bytes_per_shard"] / base_rep[
                    "kv_bytes_per_shard"]
                split = spec == "1,2" or n == "slotted"
                if (ratio > 0.51) if split else (ratio != 1.0):
                    raise AssertionError(
                        f"mesh {mname} {n} rank {r}: KV bytes per shard "
                        f"{rep['kv_bytes_per_shard']}, unsharded "
                        f"{base_rep['kv_bytes_per_shard']}")
                log(f"mesh {mname} {n} rank {r}: launches {c}; KV bytes per "
                    f"shard {rep['kv_bytes_per_shard']} (unsharded "
                    f"{base_rep['kv_bytes_per_shard']}, ratio {ratio:.6f}); "
                    f"peak memory {got['peak_memory_bytes'] / 1e9:.3f} GB; "
                    f"tokens/s {rep['tokens_per_s']:.6g}; "
                    f"{got['seconds']:.1f} s")
            streams = ranks[0]["paths"][n]["streams"]
            agree = _agreement(streams, base_streams)
            log(f"mesh {mname} {n}: streams vs the unsharded path: {agree}")
            if streams == base_streams:
                continue
            if n != "C" or flip is None:
                raise AssertionError(f"mesh {mname} {n}: streams differ from "
                                     f"the unsharded path: {agree}")
            _near_ties(f"mesh {mname} {n}", streams, base_streams,
                       prompts_c, tie_logits, 2 * fmt)
            mesh_cases._MODELS.clear()
            _release()
        log(f"mesh {mname} done at {time.time() - t_start:.1f} s")
    log(f"mesh phase: {time.time() - t_start:.1f} s (two ranks sharing one "
        "card over gloo measure correctness, not tensor-parallel speed)")
    return counts


def _near_ties(label, got, want, prompts, logits, bound):
    """Where the streams ``got`` part from the unsharded path's ``want``:
    at each request's first differing token j, ``logits(prompt,
    history)``, the unsharded kernel path teacher-forced over the
    request's prompt and the common history ``want[rid][:j]``, gives token
    j's logits row, and so both tokens' logits; raises where their gap
    exceeds ``bound``, or where no stream parts. Prints each gap."""
    gaps = []
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        lg = logits(prompts[rid], b[:j])
        gap = float(lg[b[j]] - lg[a[j]])
        gaps.append(abs(gap))
        log(f"{label}: request {rid} parts at token {j} of {len(b)} "
            f"(unsharded {b[j]}, mesh {a[j]}): logit gap {gap:.3e} on the "
            f"unsharded kernel path (top logit {float(lg.max()):.4g}; bound "
            f"{bound:.3e})")
    if not gaps or max(gaps) > bound:
        raise AssertionError(f"{label}: streams part at gaps {gaps}, bound "
                             f"{bound}")


def _release():
    """Free what earlier phases left to the collector and the caching
    allocator, and say how much device memory is still held."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated after release: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")


# ---------------------------------------------------------------------------
# the zoo over a mesh: MoE, Mamba and RWKV split over a model axis of 2
# ---------------------------------------------------------------------------

#: MZ1-MZ3: (label, arch, depth cut, dtype, engine paths), each at its
#: published widths over 1x2, its experts, Mamba channels or RWKV heads
#: split over "model": moonshot 2 of 48 layers (32 experts a rank) in
#: bf16, slotted, and in fp32, paged path A (a prefix-shared MoE prefill
#: routes its suffix alone, which no teacher-forced path replays, so path
#: A's streams are held equal, which fp32 alone keeps: in bf16 a rank's
#: partial sums round otherwise than the unsharded sums); in fp32, jamba
#: the first MZ_JAMBA_LAYERS layers of its block (4 Mamba layers, 2 of
#: them MoE, held equal slotted, and the attention layer; di 4,096 a
#: rank) and rwkv6-7b 8 of 32 layers (32 heads a rank)
MZ_JAMBA_LAYERS = 5
MZ = (("MZ1", MOE_ARCH, 2, "bf16", ("slotted",)),
      ("MZ1 fp32", MOE_ARCH, 2, "fp32", ("A",)),
      ("MZ2", MAMBA_ARCH, MZ_JAMBA_LAYERS, "fp32", ("slotted",)),
      ("MZ3", RWKV_ARCH, 8, "fp32", ("slotted",)))
#: their traffic: closed load, so the schedule (and each kernel's
#: launches) is the same on every rank and unsharded; 4 requests of
#: prompt 32 and 16 new tokens; the teacher-forced check 8 decode steps
MZ_REQUESTS, MZ_GEN, MZ_STEPS = 4, 16, 8
MZ_MAX_LEN = PROMPT + MZ_GEN + 8
#: the kernel each zoo model brings to the mesh, and every kernel its
#: paths must launch on every rank
MZ_KERNEL = {MOE_ARCH: "moe_route", MAMBA_ARCH: "mamba_scan",
             RWKV_ARCH: "rwkv_scan"}
MZ_WANT = {(MOE_ARCH, "slotted"): ("moe_route", "rmsnorm", "flash_attention",
                                   "slot_decode"),
           (MOE_ARCH, "A"): ("moe_route", "rmsnorm", "flash_attention",
                             "paged_decode"),
           (MAMBA_ARCH, "slotted"): ("mamba_scan", "moe_route", "rmsnorm",
                                     "flash_attention", "slot_decode"),
           (RWKV_ARCH, "slotted"): ("rwkv_scan", "rmsnorm")}
#: MZT: moonshot cut to 2 layers, fp32, TR1's 4 sequences at 256 tokens,
#: 2 steps, against the unsharded kernel path (TR2_TOL)
MZT_LAYERS, MZT_SEQ, MZT_STEPS = 2, 256, 2


def depth_config(arch, blocks):
    """``arch`` at its published widths, ``blocks`` blocks deep."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_blocks=blocks)


def mz_config(arch, cut):
    """``arch`` at its published widths cut in depth: ``cut`` layers
    (jamba: the first ``cut`` layers of its one block)."""
    import dataclasses
    from repro_torch.configs import get_config
    if arch != MAMBA_ARCH:
        return depth_config(arch, cut)
    cfg = get_config(arch)
    return dataclasses.replace(cfg, block_pattern=cfg.block_pattern[:cut],
                               num_blocks=1)


def _mz_path_kw(name):
    return {"slotted": {},
            "A": dict(kv="paged", block_size=BS,
                      shared_prefix_len=SHARED)}[name]


def _mz_serve_kw(cfg, dtype, name):
    """``run_engine``'s arguments for one MZ path."""
    return dict(arch=cfg, preset_name=PRESET, n_slots=SLOTS,
                prompt_len=PROMPT, gen_len=MZ_GEN, requests=MZ_REQUESTS,
                load="closed", smoke=False, device="cuda", dtype=dtype,
                **_mz_path_kw(name))


def _mz_opts(dtype="fp32"):
    """The kernel path's options (the shortcut preset's), activations in
    ``dtype`` over the model's parameters."""
    from repro_torch.launch import mesh_cases
    from repro_torch.launch.serve import DTYPES
    return mesh_cases.options(PRESET, DTYPES[dtype])[1]


def _mz_teacher(cfg, params, opts, prompt, feed, routes):
    """Prefill then MZ_STEPS slotted decode steps fed ``feed``: the logits
    (numpy). ``routes``: None (no MoE layer), an empty list (the routing
    recorded into it) or a record (replayed)."""
    from repro_torch.launch import mesh_cases
    import torch
    dev = params["embed"].device
    case = dict(backend="slotted", max_len=MZ_MAX_LEN)
    toks = torch.as_tensor(prompt, dtype=torch.int32)[None].to(dev)
    fed = [torch.tensor([t], dtype=torch.int32, device=dev) for t in feed]
    with (mesh_cases.routing(routes, replay=bool(routes))
          if routes is not None else contextlib.nullcontext()):
        return mesh_cases._teacher_run(cfg, params, case, opts, toks, fed,
                                       slice(None))["logits"]


def _mz_tie_logits(cfg, params, opts, prompt, history):
    """Token ``len(history)``'s logits row on the unsharded kernel path,
    teacher-forced over ``prompt`` and ``history`` (its routing its
    own)."""
    import numpy as np
    return np.asarray(_mz_teacher(cfg, params, opts, prompt, history,
                                  [] if cfg.moe is not None else None),
                      np.float32)[len(history)]


def _route_flips(a, b):
    """(differing, all) token rows of two routing records of one forward
    sequence (``mesh_cases.routing``'s (gates, idx) a MoE layer call)
    whose sets of chosen experts differ."""
    diff = total = 0
    for (_, ia), (_, ib) in zip(a, b):
        k = ia.shape[-1]
        sa = ia.reshape(-1, k).sort(-1).values
        sb = ib.reshape(-1, k).sort(-1).values
        diff += int((sa != sb).any(-1).sum())
        total += sa.shape[0]
    return diff, total


def _mz_params(cfg, dtype):
    import torch
    from repro_torch.launch.serve import DTYPES
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       "cuda", param_dtype=DTYPES[dtype])


def _mz_rank_model(mesh, job):
    """One zoo model in a 1x2 rank: each engine path through
    ``serve_rank`` (``run_engine`` over this rank's shard, built in turn),
    then the teacher-forced kernel path over this rank's shard, the
    unsharded run's routing replayed."""
    import dataclasses

    import torch
    from repro_torch.launch.serve import serve_rank
    from repro_torch.sharding import comm
    from repro_torch.sharding.placement import serve_shard
    out = {"paths": {}}
    for name in job["paths"]:
        comm.reset_traffic()
        t = time.time()
        with last_streams({}) as got:
            res = serve_rank(mesh, _mz_serve_kw(job["cfg"], job["dtype"],
                                                name))
        out["paths"][name] = dict(res, streams=got["streams"],
                                  seconds=time.time() - t,
                                  traffic=comm.traffic())
        torch.cuda.empty_cache()

    def build():
        params = _mz_params(job["cfg"], job["dtype"])
        sh = serve_shard(job["cfg"], params, mesh, 1)
        del params
        torch.cuda.empty_cache()
        return sh
    sh = mesh.in_turn(build)
    opts = dataclasses.replace(_mz_opts(), tp=sh.tp)
    out["teacher"] = _mz_teacher(sh.local_cfg, sh.params, opts, job["prompt"],
                                 job["feed"], job["routes"])
    del sh
    torch.cuda.empty_cache()
    return out


def _mzt_setup():
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.optim import AdamWConfig
    cfg = depth_config(MOE_ARCH, MZT_LAYERS)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=MZT_STEPS)
    return cfg, ocfg, Pipeline(cfg, DataConfig(TRAIN_BATCH, MZT_SEQ))


def _mzt_rank(mesh, ep):
    """MZT in a rank: moonshot cut to MZT_LAYERS layers, fp32, over this
    mesh (``ep``: ``ep_resident``). In turn, each rank builds the seeded
    full state, runs the unsharded kernel path (step 1's loss and
    gradient, this rank's pieces of it kept; MZT_STEPS steps' losses) and
    keeps its pieces of the initial state; then the sharded step from
    those pieces: step 1's loss, gradient norm and every piece's gradient
    against the unsharded ones, then MZT_STEPS steps."""
    import torch

    from repro_torch import tree
    from repro_torch.core import (L2_BYP, LinkageConfig,
                                  build_sharded_train_step, init_train_state,
                                  make_train_step)
    from repro_torch.data import stage
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions, loss_fn
    from repro_torch.optim import adamw
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import shard, shard_leaf, spec_leaves
    kernel = ModelOptions(attn_impl="kernel", scan_impl="ref",
                          dtype=torch.float32, fused_norm=True)
    lk = LinkageConfig(level=L2_BYP, shortcut=True)
    cfg, ocfg, pipe = _mzt_setup()
    raw = [pipe.batch_at(i) for i in range(MZT_STEPS)]

    def reference():
        state = init_train_state(cfg, ocfg, torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        fn, sspecs, bspecs = build_sharded_train_step(
            cfg, kernel, ocfg, lk, mesh, state, TRAIN_BATCH, ep_resident=ep)
        pieces = shard(state, sspecs, mesh)
        live = [p.detach().requires_grad_(True)
                for p in tree.leaves(state.params)]
        loss, _ = loss_fn(tree.unflatten(state.params, live),
                          stage(raw[0], "cuda"), cfg, kernel)
        grads = torch.autograd.grad(loss, live)
        del live
        ref = {"loss": float(loss.detach()),
               "grad_norm": math.sqrt(sum(float(g.double().square().sum())
                                          for g in grads))}
        want = [shard_leaf(g, sp, mesh, mesh.coords)
                for g, sp in zip(grads, spec_leaves(sspecs.params))]
        del grads, loss
        step = make_train_step(cfg, kernel, ocfg, inplace=True)
        ref["losses"] = []
        for b in raw:
            state, m = step(state, stage(b, "cuda"))
            ref["losses"].append(float(m["loss"]))
        del state, step, m
        torch.cuda.empty_cache()
        return fn, sspecs, bspecs, pieces, want, ref

    fn, sspecs, bspecs, pieces, want, ref = mesh.in_turn(reference)
    out = {"ref": ref, "mesh": mesh.describe(), "rank": mesh.rank}
    batches = [stage(b, "cuda", bspecs, mesh) for b in raw]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comm.reset_traffic()
    out["losses"], out["step_s"] = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g, m = fn.grads(pieces.params, b)
        if i == 0:
            out["loss"], out["moe_aux"] = float(m["loss"]), float(
                m["moe_aux"])
            out["grad_norm"] = float(adamw.global_norm(g, sspecs.params,
                                                       mesh))
            errs = [float((a - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
                    for a, w in zip(tree.leaves(g), want)]
            out["max_rel_grad_diff"] = max(errs)
            router = [e for e, (p, _) in zip(errs, _leaf_paths(pieces.params))
                      if p.endswith("router")]
            out["router_rel_grad_diff"] = max(router)
            del want
        pieces, m = fn.apply(pieces, g, m)
        del g
        out["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t)
    out["launches"] = ops.launch_counts()
    out["traffic"] = comm.traffic()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del pieces, batches
    torch.cuda.empty_cache()
    return out


def _leaf_paths(params):
    """(path, leaf) of a parameter tree in ``tree.leaves`` order."""
    from repro_torch.sharding.rules import _map_with_path
    out = []
    _map_with_path(lambda p, leaf: out.append(("/".join(p), leaf)), params)
    return out


def _mesh_zoo_rank(mesh, jobs, flm):
    """One rank of ``mesh_zoo_phase``'s spawn: MZ1-MZ3, MZT
    (``tp_experts``), FLM through the fleet launcher's rank entry (what
    ``launch/fleet.py --mesh 1,2`` runs in each rank), then MZT with
    ``ep_resident`` over a 2x1 mesh of the same two ranks."""
    import torch
    from repro_torch.launch.fleet import fleet_rank
    out = {"zoo": {}, "backend": mesh.backend, "device": str(mesh.device)}
    for job in jobs:
        t = time.time()
        out["zoo"][job["label"]] = dict(_mz_rank_model(mesh, job),
                                        seconds=time.time() - t)
    t = time.time()
    out["mzt"] = dict(_mzt_rank(mesh, False), seconds=time.time() - t)
    t = time.time()
    with last_streams({}, fleet=True) as got:
        res = fleet_rank(mesh, flm)
    out["flm"] = dict(res, streams=got["streams"], seconds=time.time() - t)
    torch.cuda.empty_cache()
    t = time.time()
    out["mzt_ep"] = dict(_mzt_rank(_over(mesh, "2,1"), True),
                         seconds=time.time() - t)
    return out


def mesh_zoo_kernel_rows(gen):
    """The zoo's kernels at a 1x2 rank's local shapes against their plain
    versions (labels ``mesh zoo``): ``mamba_scan`` at jamba's admission
    with di 4,096 (1,32,4096,16), ``rwkv_scan`` at rwkv6-7b's with 32 heads
    (1,32,32,64), fp32, within 1e-4; the router, whole on every rank, at
    moonshot's decode rows (bf16) and jamba's (fp32) through
    ``check_route``. Each timed (CUDA events, kernel and plain version)
    beside its bound."""
    import torch
    from repro_torch.kernels import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}
    for kernel, label, args, call, plain, n_ops in (
            ("mamba_scan", "mesh zoo: admission (1,32,4096,16)",
             mamba_inputs(gen, 1, PROMPT, 4096, 16, f32), ops.mamba_scan,
             ref.mamba_scan_ref, mamba_scan_ops(1, PROMPT, 4096, 16)),
            ("rwkv_scan", "mesh zoo: admission (1,32,32,64)",
             rwkv_inputs(gen, 1, PROMPT, 32, 64, f32, f32), ops.rwkv_scan,
             ref.rwkv_scan_ref, rwkv_scan_ops(1, PROMPT, 32, 64))):
        got, want = call(*args), plain(*args)
        torch.cuda.synchronize()
        err = max(check_close(f"{kernel} [{label}] {what}", g, w, f32)
                  for what, g, w in zip(("y", "state"), got, want))
        b_ms, b_by = bound(nbytes(*args, *got), n_ops, "torch.float32")
        row = {"label": label, "dtype": str(f32), "max_abs_err": err,
               "ms": cuda_ms(lambda: call(*args)),
               "plain_ms": cuda_ms(lambda: plain(*args), iters=20),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        _log_row(kernel, row)
        rows[kernel] = [row]
    rows["moe_route"] = []
    for label, D, E, k, dtype in (
            ("mesh zoo: moonshot decode x (4,2048) router (2048,64) k=6",
             2048, 64, 6, bf16),
            ("mesh zoo: jamba decode x (4,4096) router (4096,16) k=2", 4096,
             16, 2, f32)):
        x = torch.randn(SLOTS, D, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(D, E, generator=gen, device="cuda") * 0.02).to(dtype)
        got, want = ops.moe_route(x, w, k), ref.moe_route_ref(x, w, k)
        torch.cuda.synchronize()
        err, _, _ = check_route(f"moe_route [{label}]", got, want, x, w, k,
                                False)
        b_ms, b_by = bound(nbytes(x, w, *got), 2.0 * SLOTS * D * E,
                           str(dtype))
        row = {"label": label, "dtype": str(dtype), "max_abs_err": err,
               "ms": cuda_ms(lambda: ops.moe_route(x, w, k)),
               "plain_ms": cuda_ms(lambda: ref.moe_route_ref(x, w, k)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        _log_row("moe_route", row)
        rows["moe_route"].append(row)
    return rows


def mesh_zoo_phase(gen, tol: float = 2e-3):
    """The zoo's MoE, Mamba and RWKV models over a mesh (ROADMAP entry
    9c), every rank's pieces only on the card (built in turn: one full
    copy at a time), both ranks on the one H100 over gloo (correctness,
    not tensor-parallel speed). Each model's unsharded reference runs
    first in this process and is freed before the next one.

    MZ1-MZ3  (``MZ``) at 1x2: each engine path through ``run_engine`` in
         every rank, closed load, MZ_REQUESTS requests of PROMPT + MZ_GEN;
         every request finished, every kernel of the path launched on
         every rank, the model's own kernel (``MZ_KERNEL``) as many times
         a rank as unsharded, the KV bytes per shard below the unsharded
         path's (the RWKV token shifts stay whole), the streams equal to
         the unsharded path's (slotted: or parting only at near ties,
         ``_near_ties`` on the unsharded kernel path at the model's
         precision, gap <= 2 x ``tol`` in fp32 and <= 2 x ``fmt`` in
         bf16, ``fmt`` the largest |dlogit| between its bf16 and f32
         activations); the teacher-forced kernel path (prefill + MZ_STEPS
         slotted decode steps, float32 activations over the model's
         parameters, the unsharded run's routing replayed) within ``tol``
         of the unsharded kernel path.
    MZT  moonshot cut to 2 layers at 1x2 (``tp_experts``) and at 2x1 with
         ``ep_resident``: step 1's loss and gradient norm within TR2_TOL
         of the unsharded kernel path, every piece's gradient (the router
         among them) within TR2_TOL["grad"] of its max, MZT_STEPS steps'
         losses within 10 x lr.
    FLM  the fleet launcher's rank entry at 1x2, tinyllama-1.1b cut to
         MAIN_BLOCKS layers, 2 colocated replicas: every request finished,
         the streams equal to the unsharded fleet's.

    The kernel rows at the ranks' local shapes come first
    (``mesh_zoo_kernel_rows``). Printed: seconds, tokens/s, peak memory a
    rank and bytes to each kind of collective, beside the card's name
    and power limit. Returns (launch counts by case, kernel rows)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.fleet import run_fleet_engine
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import run_engine
    from repro_torch.serve import synthetic_requests

    t_start = time.time()
    smi = nvidia_smi()
    rows = mesh_zoo_kernel_rows(gen)
    rng = np.random.default_rng(3)
    jobs, refs = [], {}
    for label, arch, cut, dtype, paths in MZ:
        cfg = mz_config(arch, cut)
        base = {}
        for name in paths:
            ops.reset_launch_counts()
            with last_streams({}) as got:
                rep = run_engine(**_mz_serve_kw(cfg, dtype, name))
            base[name] = (rep, got["streams"], ops.launch_counts())
            _release()
        prompt = rng.integers(0, cfg.vocab_size, PROMPT).tolist()
        feed = rng.integers(0, cfg.vocab_size, MZ_STEPS).tolist()
        routes = [] if cfg.moe is not None else None
        params = _mz_params(cfg, dtype)
        logits = _mz_teacher(cfg, params, _mz_opts(), prompt, feed, routes)
        # the near-tie bound: fp32 streams part only within twice ``tol``;
        # bf16 ones within twice ``fmt``, the largest |dlogit| between the
        # unsharded kernel path's bf16 and f32 activations (each its own
        # routing): the format's own size, as the mesh phase's path C
        # measures int8's
        fmt = None
        if dtype != "fp32":
            own_routes = None if routes is None else []
            own = _mz_teacher(cfg, params, _mz_opts(dtype), prompt, feed,
                              own_routes)
            fmt = float(np.abs(np.asarray(own, np.float32) - logits).max())
            flips = ("" if routes is None else "; (token, layer) expert "
                     "choices that differ: %d of %d (not gated)"
                     % _route_flips(routes, own_routes))
            log(f"mesh zoo {label}: {dtype} against f32 activations on the "
                f"unsharded kernel path (fmt): max |dlogit| {fmt:.3e}"
                + flips)
        del params
        _release()
        jobs.append(dict(label=label, arch=arch, cfg=cfg, dtype=dtype,
                         paths=paths, prompt=prompt, feed=feed,
                         routes=routes))
        refs[label] = (base, logits, 2 * (tol if fmt is None else fmt))
        log(f"mesh zoo {label} ({arch}, {cfg.num_layers} layers, {dtype}): "
            f"unsharded references done at {time.time() - t_start:.1f} s")
    flm = dict(arch=main_config(), preset_name=PRESET, replicas=2,
               n_slots=SLOTS, prompt_len=PROMPT, gen_len=MZ_GEN,
               requests=MZ_REQUESTS, load="closed", kv="paged",
               block_size=BS, shared_prefix_len=SHARED, smoke=False,
               device="cuda")
    ops.reset_launch_counts()
    with last_streams({}, fleet=True) as got:
        flm_rep = run_fleet_engine(**flm)
    flm_ref = (flm_rep, got["streams"], ops.launch_counts())
    _release()
    log(f"mesh zoo FLM: the unsharded fleet done at "
        f"{time.time() - t_start:.1f} s")

    t0 = time.time()
    ranks = spawn(_mesh_zoo_rank, "1,2", "cuda", (jobs, flm),
                  deadline_s=900)
    log(f"mesh zoo 1x2: {len(ranks)} ranks, backend {ranks[0]['backend']}, "
        f"devices {[r['device'] for r in ranks]}, spawn "
        f"{time.time() - t0:.1f} s")
    counts = {}
    for job in jobs:
        label = job["label"]
        base, want, tie_bound = refs[label]
        worst = max(float(np.abs(r["zoo"][label]["teacher"] - want).max())
                    for r in ranks)
        log(f"mesh zoo {label} teacher-forced (kernels, f32 activations, "
            f"prefill + {MZ_STEPS} slotted decode steps"
            + (", routing replayed" if job["routes"] is not None else "")
            + f") 1x2 vs unsharded: max |dlogit| {worst:.3e} (tolerance "
            f"{tol}; logit scale {float(np.abs(want).max()):.4g})")
        if not worst <= tol:
            raise AssertionError(f"mesh zoo {label} teacher-forced: logits "
                                 f"differ by {worst}")
        for name in job["paths"]:
            base_rep, base_streams, base_counts = base[name]
            for r, rank in enumerate(ranks):
                got = rank["zoo"][label]["paths"][name]
                rep = got["report"]
                c = counts[f"{label} {name} rank {r}"] = got["launches"]
                if (rep["requests"] != MZ_REQUESTS
                        or rep["total_tokens"] != MZ_REQUESTS * MZ_GEN):
                    raise AssertionError(
                        f"mesh zoo {label} {name} rank {r}: "
                        f"{rep['requests']} requests, {rep['total_tokens']} "
                        "tokens")
                for k in MZ_WANT[job["arch"], name]:
                    if c.get(k, 0) < 1:
                        raise AssertionError(f"mesh zoo {label} {name} rank "
                                             f"{r}: kernel {k} never "
                                             "launched")
                k = MZ_KERNEL[job["arch"]]
                if c.get(k) != base_counts.get(k):
                    raise AssertionError(
                        f"mesh zoo {label} {name} rank {r}: {k} launched "
                        f"{c.get(k)} times, unsharded {base_counts.get(k)}")
                ratio = rep["kv_bytes_per_shard"] / base_rep[
                    "kv_bytes_per_shard"]
                if not ratio < 1:
                    raise AssertionError(
                        f"mesh zoo {label} {name} rank {r}: KV bytes per "
                        f"shard {rep['kv_bytes_per_shard']}, unsharded "
                        f"{base_rep['kv_bytes_per_shard']}")
                log(f"mesh zoo {label} {name} rank {r} [{smi}]: launches "
                    f"{c} (unsharded {k} {base_counts.get(k)}); KV bytes per "
                    f"shard {rep['kv_bytes_per_shard']} (unsharded "
                    f"{base_rep['kv_bytes_per_shard']}, ratio {ratio:.6f}); "
                    f"peak memory {got['peak_memory_bytes'] / 1e9:.3f} GB; "
                    f"tokens/s {rep['tokens_per_s']:.6g} (unsharded "
                    f"{base_rep['tokens_per_s']:.6g}); {got['seconds']:.1f} "
                    f"s; bytes to collectives {got['traffic']}")
            streams = ranks[0]["zoo"][label]["paths"][name]["streams"]
            if any(r["zoo"][label]["paths"][name]["streams"] != streams
                   for r in ranks):
                raise AssertionError(f"mesh zoo {label} {name}: the ranks' "
                                     "streams differ")
            agree = _agreement(streams, base_streams)
            log(f"mesh zoo {label} {name}: streams vs the unsharded path: "
                f"{agree}")
            if streams != base_streams:
                if name != "slotted":
                    # a prefix-shared MoE prefill routes its suffix alone
                    # (capacity over fewer tokens): no teacher-forced
                    # prefill replays it, so path A must agree
                    raise AssertionError(f"mesh zoo {label} {name}: streams "
                                         f"differ: {agree}")
                cfg = job["cfg"]
                reqs = synthetic_requests(MZ_REQUESTS, PROMPT, MZ_GEN,
                                          cfg.vocab_size, seed=0)
                params = _mz_params(cfg, job["dtype"])
                _near_ties(f"mesh zoo {label} {name}", streams, base_streams,
                           {r.rid: r.prompt.tolist() for r in reqs},
                           functools.partial(_mz_tie_logits, cfg, params,
                                             _mz_opts(job["dtype"])),
                           tie_bound)
                del params
                _release()
        secs = max(r["zoo"][label]["seconds"] for r in ranks)
        log(f"mesh zoo {label}: {secs:.1f} s in the ranks")

    for mname, key in (("1x2 tp_experts", "mzt"),
                       ("2x1 ep_resident", "mzt_ep")):
        for r, rank in enumerate(ranks):
            got = rank[key]
            ref = got["ref"]
            counts[f"MZT {mname} rank {r}"] = got["launches"]
            log(f"mesh zoo MZT {mname} rank {r} [{smi}]: loss "
                f"{got['loss']:.7g} (unsharded {ref['loss']:.7g}), aux "
                f"{got['moe_aux']:.7g}, grad norm {got['grad_norm']:.7g} "
                f"(unsharded {ref['grad_norm']:.7g}), max |dgrad|/max|grad| "
                f"{got['max_rel_grad_diff']:.3e} (router "
                f"{got['router_rel_grad_diff']:.3e}), losses {got['losses']} "
                f"(unsharded {ref['losses']}); step s {got['step_s']}; peak "
                f"memory {got['peak_memory_bytes'] / 1e9:.3f} GB; bytes to "
                f"collectives {got['traffic']}; launches {got['launches']}; "
                f"{got['seconds']:.1f} s")
            bad = []
            for k in ("loss", "grad_norm"):
                if not abs(got[k] - ref[k]) <= TR2_TOL[k] * abs(ref[k]):
                    bad.append(k)
            if not got["max_rel_grad_diff"] <= TR2_TOL["grad"]:
                bad.append("grad")
            if not all(abs(a - b) <= TR2_TOL["losses"] for a, b in
                       zip(got["losses"], ref["losses"])):
                bad.append("losses")
            if got["launches"].get("flash_attention_bwd", 0) < 1:
                bad.append("flash_attention_bwd launches")
            if bad:
                raise AssertionError(f"mesh zoo MZT {mname} rank {r}: {bad}")

    flm_rep, flm_streams, flm_counts = flm_ref
    for r, rank in enumerate(ranks):
        got = rank["flm"]
        rep = got["report"]
        counts[f"FLM rank {r}"] = got["launches"]
        log(f"mesh zoo FLM rank {r} [{smi}]: {rep['requests']} requests, "
            f"{rep['total_tokens']} tokens, mesh {rep.get('mesh')}, handoffs "
            f"{rep['fleet_handoffs']}; launches {got['launches']}; peak "
            f"memory {got['peak_memory_bytes'] / 1e9:.3f} GB; tokens/s "
            f"{rep['tokens_per_s']:.6g} (unsharded "
            f"{flm_rep['tokens_per_s']:.6g}); {got['seconds']:.1f} s")
        if (rep["requests"] != MZ_REQUESTS or rep.get("mesh") != "1x2"
                or got["streams"] != flm_streams):
            raise AssertionError(
                f"mesh zoo FLM rank {r}: {rep['requests']} requests, mesh "
                f"{rep.get('mesh')}, streams "
                f"{_agreement(got['streams'], flm_streams)}")
    log(f"mesh zoo phase: {time.time() - t_start:.1f} s [{smi}] (two ranks "
        "sharing one card over gloo measure correctness, not "
        "tensor-parallel speed)")
    return counts, rows


def moe_path_phase():
    """The MoE main path through its entry point: ``run_engine`` on
    moonshot-v1-16b-a3b at full width and depth, bf16 parameters and
    activations, ``nss_shortcut``, 4 slots, prompt 32, gen 32, 8 requests
    at open load. Every request must finish with its budget; moe_route,
    rmsnorm, flash_attention and slot_decode must launch, moe_route once
    per layer of every forward pass (48 per admission, 48 per decode
    microstep: flash counts the admissions, slot decode the microsteps).
    Prints the report, the counts and the peak device memory; returns the
    counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_engine

    n_layers = get_config(MOE_ARCH).num_layers
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = run_engine(MOE_ARCH, PRESET, n_slots=SLOTS, prompt_len=PROMPT,
                     gen_len=GEN, requests=REQUESTS, load="open",
                     smoke=False, device="cuda", dtype="bf16")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("serve report (moe, open):", json.dumps(rep))
    log("launches (moe, open):", counts)
    log(f"moe path: peak device memory {peak / 1e9:.3f} GB "
        f"(max_memory_allocated)")
    if rep["requests"] != REQUESTS or rep["total_tokens"] != REQUESTS * GEN:
        raise AssertionError(f"moe path: {rep['requests']} requests, "
                             f"{rep['total_tokens']} tokens; want "
                             f"{REQUESTS} x {GEN}")
    for k in ("moe_route", "rmsnorm", "flash_attention", "slot_decode"):
        if counts.get(k, 0) < 1:
            raise AssertionError(f"moe path: kernel {k} was never launched")
    admissions = counts["flash_attention"] / n_layers
    microsteps = counts["slot_decode"] / n_layers
    log(f"moe path: {admissions:g} admissions, {microsteps:g} decode "
        f"microsteps (warm-up included); moe_route {counts['moe_route']} = "
        f"{counts['moe_route'] / n_layers:g} x {n_layers} layers")
    if counts["moe_route"] != n_layers * (admissions + microsteps):
        raise AssertionError("moe path: moe_route did not launch once per "
                             "layer of every admission and microstep")
    return counts


@contextlib.contextmanager
def routes(log: list, replay: bool):
    """The MoE layers' routing steps (``layers._route``), in call order:
    recorded into the list ``log`` as (output, router, tokens), or
    (``replay``) replaced by the outputs of the next entries of the
    iterator ``log``, so a second run routes exactly as the first one
    did."""
    from repro_torch.models import layers
    orig, recorded = layers._route, iter(log)

    def route(router, xt, K, opts):
        if replay:
            return next(recorded)[0]
        out = orig(router, xt, K, opts)
        log.append((out, router, xt))
        return out

    layers._route = route
    try:
        yield
    finally:
        layers._route = orig


def moe_teacher_forced_phase(params, cfg, steps: int = 8, tol: float = 2e-3):
    """Prefill 32 tokens, then ``steps`` slotted decode steps, at full
    width over the bf16 parameters: kernels against plain versions on the
    card, both fed the plain path's tokens. Gated: float32 activations
    (each bf16 weight cast on use, as JAX's ``.astype(x.dtype)``), the
    kernel path replaying the plain path's routing (``routes``): top-k
    routing is discontinuous, and an ulp of difference upstream flips a
    near-tied 6th/7th expert, so the gate holds the kernels' arithmetic
    with the expert choice shared, max |dlogit| <= ``tol``. Printed: the
    kernel path routing on its own, how many (token, layer) choices it
    made differently with the smallest plain probability gap among them,
    and the bf16-activation run (each path its own routing)."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions, decode_step_slots, prefill
    from repro_torch.models.layers import router_probs
    from repro_torch.serve import slotify

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PROMPT),
                                         dtype=np.int32)).cuda()

    def run(opts, log, replay, feed=None):
        """Logits of the prefill and of each decode step; the tokens fed
        are ``feed``'s, or this run's own greedy ones."""
        with routes(log, replay):
            lg, cache = prefill(params, toks, cfg, opts, MAX_LEN)
        cache, out, fed = slotify(cache), [lg], []
        for i in range(steps):
            nxt = (feed[i] if feed is not None
                   else torch.argmax(lg, -1).to(torch.int32))
            fed.append(nxt)
            with routes(log, replay):
                lg, cache = decode_step_slots(params, cache, nxt, cfg, opts)
            out.append(lg)
        return out, fed

    def worst(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    plain = ModelOptions(attn_impl="ref", dtype=torch.float32)
    kern = preset(PRESET).model_options(plain)
    plain_log, own_log = [], []
    lp, feed = run(plain, plain_log, replay=False)
    lk, _ = run(kern, iter(plain_log), replay=True, feed=feed)
    torch.cuda.synchronize()
    w = worst(lp, lk)
    log(f"teacher-forced (moe, f32 activations over bf16 parameters, "
        f"prefill + {steps} slotted decode steps, routing replayed) max "
        f"|dlogit|: {w:.3e} (tolerance {tol}; logit scale "
        f"{lp[-1].abs().max().item():.3g})")
    if not math.isfinite(w) or w > tol:
        raise AssertionError(f"teacher-forced (moe) logits differ by {w}")
    lo, _ = run(kern, own_log, replay=False, feed=feed)
    K = cfg.moe.top_k
    differ, total, gaps = 0, 0, []
    for ((_, pi), w, xt), ((_, oi), _, _) in zip(plain_log, own_log):
        bad = (torch.sort(pi, -1).values != torch.sort(oi, -1).values).any(-1)
        differ += int(bad.sum())
        total += bad.numel()
        if bad.any():
            pp = router_probs(w, xt, plain)
            top = torch.sort(pp[bad].float(), -1, descending=True).values
            gaps.append((top[:, K - 1] - top[:, K]).min().item())
    log(f"moe kernel path routing on its own: max |dlogit| "
        f"{worst(lp, lo):.4e}; {differ} of {total} (token, layer) expert "
        f"choices differed from the plain path's, smallest plain "
        f"k-th/(k+1)-th probability gap among them "
        f"{min(gaps) if gaps else float('nan'):.3e} (not gated)")
    bplain = ModelOptions(attn_impl="ref", dtype=torch.bfloat16)
    lbp, _ = run(bplain, [], replay=False, feed=feed)
    lbk, _ = run(preset(PRESET).model_options(bplain), [], replay=False,
                 feed=feed)
    torch.cuda.synchronize()
    log(f"moe bf16 activations, kernels vs plain (each its own routing): "
        f"max |dlogit| {worst(lbp, lbk):.4e}; bf16 plain vs the f32 plain: "
        f"{worst(lbp, lp):.4e} (not gated)")


def moe_profile_phase(params, cfg):
    """Where one MoE engine run's time goes: 4 slots, each admitted with a
    32-token prompt, then one 32-step L3 program, bf16, ``nss_shortcut``:
    wall time, device busy, idle share, the top kernels (the expert GEMMs
    first), and the router and attention kernels by name."""
    import dataclasses

    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions
    from repro_torch.serve import ServeEngine, synthetic_requests

    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.bfloat16))
    reqs = synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size, seed=7)
    eng = ServeEngine(cfg, params, opts, lk, n_slots=SLOTS, max_len=MAX_LEN)
    _profile_run(f"moe slotted: {SLOTS} admissions + one {GEN}-step decode "
                 "program, bf16", eng, reqs,
                 also=("route", "decode", "flash", "rmsnorm"))


def moe_phases(check: bool = True):
    """The MoE path, then its teacher-forced check (``check``) and its
    profile over one seeded set of bf16 parameters (56.1 GB; the path
    phase's own are freed first). Returns the path's launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    _release()
    counts = moe_path_phase()
    _release()
    cfg = get_config(MOE_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda", param_dtype=torch.bfloat16)
    if check:
        moe_teacher_forced_phase(params, cfg)
    moe_profile_phase(params, cfg)
    del params
    _release()
    return counts


# ---------------------------------------------------------------------------
# the RWKV path: full-width, full-depth rwkv6-7b in fp32
# ---------------------------------------------------------------------------

PAGED_KERNELS = ("paged_decode", "paged_prefill", "paged_decode_quant",
                 "paged_prefill_quant")
ATTENTION_KERNELS = ("flash_attention", "slot_decode") + PAGED_KERNELS


def rwkv_path_phase():
    """The RWKV main path through its entry point: ``run_engine`` on
    rwkv6-7b at full width and depth, fp32 parameters and activations,
    ``nss_shortcut``, 4 slots, prompt 32, gen 32, 8 requests at open load.
    Every request must finish with its budget; rwkv_scan must launch once
    per layer of every admission (the 8 requests and the warm-up one) and
    never at decode (``rwkv_decode`` is plain PyTorch, as in JAX); rmsnorm
    must launch, 2 per layer and one more per forward; no attention kernel
    may. Prints the report, the counts and the peak device memory; returns
    the counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_engine

    n_layers = get_config(RWKV_ARCH).num_layers
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = run_engine(RWKV_ARCH, PRESET, n_slots=SLOTS, prompt_len=PROMPT,
                     gen_len=GEN, requests=REQUESTS, load="open",
                     smoke=False, device="cuda", dtype="fp32")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("serve report (rwkv, open):", json.dumps(rep))
    log("launches (rwkv, open):", counts)
    log(f"rwkv path: peak device memory {peak / 1e9:.3f} GB "
        f"(max_memory_allocated)")
    if rep["requests"] != REQUESTS or rep["total_tokens"] != REQUESTS * GEN:
        raise AssertionError(f"rwkv path: {rep['requests']} requests, "
                             f"{rep['total_tokens']} tokens; want "
                             f"{REQUESTS} x {GEN}")
    admissions = REQUESTS + 1                    # run_engine's warm-up too
    if counts.get("rwkv_scan", 0) != n_layers * admissions:
        raise AssertionError(f"rwkv path: rwkv_scan launched "
                             f"{counts.get('rwkv_scan', 0)} times, want "
                             f"{n_layers} layers x {admissions} admissions")
    forwards, rest = divmod(counts.get("rmsnorm", 0), 2 * n_layers + 1)
    if rest or forwards <= admissions:
        raise AssertionError(f"rwkv path: rmsnorm launched "
                             f"{counts.get('rmsnorm', 0)} times, not "
                             f"{2 * n_layers + 1} per forward")
    launched = [k for k in ATTENTION_KERNELS if counts.get(k, 0)]
    if launched:
        raise AssertionError(f"rwkv path launched attention kernels "
                             f"{launched}")
    log(f"rwkv path: {admissions} admissions x {n_layers} layers = "
        f"{counts['rwkv_scan']} rwkv_scan launches; "
        f"{forwards - admissions} decode microsteps (warm-up included)")
    return counts


@contextlib.contextmanager
def _layer_input_hook(hook):
    """Every layer's input in the prefill and the decode steps
    (``transformer._prefill_layer``, ``transformer.apply_layer_decode``),
    in call order, passed through ``hook`` before the layer runs."""
    from repro_torch.models import transformer
    saved = (transformer._prefill_layer, transformer.apply_layer_decode)

    def wrap(fn):
        def layer(p, x, *a, **kw):
            return fn(p, hook(x), *a, **kw)
        return layer

    transformer._prefill_layer, transformer.apply_layer_decode = map(wrap,
                                                                     saved)
    try:
        yield
    finally:
        transformer._prefill_layer, transformer.apply_layer_decode = saved


def layer_inputs(log, replay: bool):
    """Every layer's input recorded into the list ``log``, or
    (``replay``) replaced by the next entry of the iterator ``log``, so
    every layer of a second run starts from the first run's input, and the
    two runs differ only by each layer's own arithmetic."""
    def hook(x):
        if replay:
            return next(log)
        log.append(x.clone())
        return x
    return _layer_input_hook(hook)


def first_layer_nudged(n_layers: int):
    """The input of every forward's first layer (the embedding's output)
    moved one ulp towards +inf (``torch.nextafter``), the rest of the run
    untouched: a difference the size of one rounding, made in the plain
    path alone."""
    import torch
    calls = iter(range(1 << 30))

    def hook(x):
        if next(calls) % n_layers:
            return x
        return torch.nextafter(x, torch.full_like(x, math.inf))
    return _layer_input_hook(hook)


def rwkv_teacher_forced_phase(params, cfg, steps: int = 8,
                              tol: float = 2e-3):
    """Prefill 32 tokens, then ``steps`` slotted decode steps, at full
    width and depth in fp32, kernels against plain versions on the card,
    both fed the plain path's greedy tokens. Gated: the kernel path
    replaying the plain path's layer inputs (``layer_inputs``), max
    |dlogit| <= ``tol``: the random-init model at full width amplifies a
    difference of one ulp by about 2-3x per layer, so with every layer
    running on its own input the kernel path's logits drift by far more
    than the kernels' arithmetic explains. Printed, not gated: that
    free-running drift, and beside it the witness that the drift is the
    model's: the plain path against itself with each forward's embedding
    output moved one ulp (``first_layer_nudged``). The prefill's final
    states (every layer) are compared in each run."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions, decode_step_slots, prefill
    from repro_torch.serve import slotify

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PROMPT),
                                         dtype=np.int32)).cuda()
    plain = ModelOptions(attn_impl="ref", dtype=torch.float32)
    kern = preset(PRESET).model_options(plain)

    def run(opts, hook, feed=None):
        """Logits of the prefill and of each decode step, the prefill's
        states, with each forward's layers under ``hook()``; the tokens
        fed are ``feed``'s, or this run's own greedy ones."""
        with hook():
            lg, cache = prefill(params, toks, cfg, opts, MAX_LEN)
        states = [g["state"].clone() for g in cache]
        cache, out, fed = slotify(cache), [lg], []
        for i in range(steps):
            nxt = (feed[i] if feed is not None
                   else torch.argmax(lg, -1).to(torch.int32))
            fed.append(nxt)
            with hook():
                lg, cache = decode_step_slots(params, cache, nxt, cfg, opts)
            out.append(lg)
        return out, states, fed

    def worst(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    def drift(name, logits, states):
        log(f"{name}: max |dlogit| {worst(lp, logits):.4e}, prefill state "
            f"max |error| {worst(sp, states):.4e}, by layer "
            + " ".join(f"{(a - b).abs().max().item():.2e}"
                       for a, b in zip(sp[::4], states[::4]))
            + " (every 4th; not gated)")

    plain_log = []
    lp, sp, feed = run(plain, lambda: layer_inputs(plain_log, False))
    replayed = iter(plain_log)
    lk, sk, _ = run(kern, lambda: layer_inputs(replayed, True), feed)
    lf, sf, _ = run(kern, contextlib.nullcontext, feed)
    ln, sn, _ = run(plain, lambda: first_layer_nudged(cfg.num_layers), feed)
    torch.cuda.synchronize()
    w = worst(lp, lk)
    log(f"teacher-forced (rwkv, fp32, prefill + {steps} slotted decode "
        f"steps, layer inputs replayed) max |dlogit|: {w:.3e} (tolerance "
        f"{tol}; logit scale {lp[-1].abs().max().item():.3g}); prefill "
        f"state max |error| {worst(sp, sk):.3e} over {len(sp)} layers "
        f"(state scale {max(t.abs().max().item() for t in sp):.3g})")
    drift("rwkv kernel path on its own inputs", lf, sf)
    drift("rwkv plain path, embedding output moved one ulp", ln, sn)
    if not math.isfinite(w) or w > tol:
        raise AssertionError(f"teacher-forced (rwkv) logits differ by {w}")


def rwkv_profile_phase(params, cfg):
    """Where one RWKV engine run's time goes: 4 slots, each admitted with a
    32-token prompt, then one 32-step L3 program, fp32, ``nss_shortcut``:
    wall time, device busy, idle share, the top kernels (the GEMMs first),
    and the scan and norm kernels by name."""
    import dataclasses

    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions
    from repro_torch.serve import ServeEngine, synthetic_requests

    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size, seed=7)
    eng = ServeEngine(cfg, params, opts, lk, n_slots=SLOTS, max_len=MAX_LEN)
    _profile_run(f"rwkv slotted: {SLOTS} admissions + one {GEN}-step decode "
                 "program, fp32", eng, reqs, also=("rwkv", "rmsnorm"))


def rwkv_phases(check: bool = True):
    """The RWKV path, then its teacher-forced check (``check``) and its
    profile over one seeded set of fp32 parameters (32.2 GB; the path
    phase's own are freed first). Returns the path's launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    _release()
    counts = rwkv_path_phase()
    _release()
    cfg = get_config(RWKV_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if check:
        rwkv_teacher_forced_phase(params, cfg)
    rwkv_profile_phase(params, cfg)
    del params
    _release()
    return counts


# ---------------------------------------------------------------------------
# the Mamba path: full-width jamba-v0.1-52b, 1 of its 4 blocks, in fp32
# ---------------------------------------------------------------------------

def mamba_config():
    """jamba-v0.1-52b at its published widths, cut to the first of its 4
    blocks (8 layers: 7 Mamba, 1 attention; 4 MoE MLPs, 4 dense): 13.3 B
    parameters, 53.2 GB in fp32, where the whole model (51.57 B) does not
    fit one 80 GB card in any dtype the port serves."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MAMBA_ARCH), num_blocks=MAMBA_BLOCKS)


def mamba_path_phase():
    """The Mamba main path through its entry point: ``run_engine`` on
    jamba-v0.1-52b at full width, depth cut to one block, fp32 parameters
    and activations, ``nss_shortcut``, 4 slots, prompt 32, gen 32, 8
    requests at open load. Every request must finish with its budget;
    mamba_scan must launch once per Mamba layer of every admission (the 8
    requests and the warm-up one) and never at decode (``mamba_decode`` is
    plain PyTorch, as in JAX); flash_attention once per admission (one
    attention layer), slot_decode once per decode microstep, moe_route once
    per MoE layer of every forward, rmsnorm 2 per layer and one more per
    forward; no paged kernel and no rwkv_scan. Prints the report, the
    counts, the peak device memory and the depth cut; returns the
    counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA, MOE
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_engine

    cfg = mamba_config()
    full = get_config(MAMBA_ARCH)
    n_layers = cfg.num_layers
    n_mamba = sum(s.mixer == MAMBA for s in cfg.block_pattern) * MAMBA_BLOCKS
    n_attn = n_layers - n_mamba
    n_moe = sum(s.mlp == MOE for s in cfg.block_pattern) * MAMBA_BLOCKS
    log(f"mamba path: {MAMBA_ARCH} at full width, depth cut to "
        f"{MAMBA_BLOCKS} of {full.num_blocks} blocks ({n_layers} of "
        f"{full.num_layers} layers: {n_mamba} Mamba, {n_attn} attention, "
        f"{n_moe} MoE MLPs): {cfg.param_count() / 1e9:.4f} B of "
        f"{full.param_count() / 1e9:.4f} B parameters, "
        f"{cfg.param_count() * 4 / 1e9:.2f} GB in fp32")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = run_engine(cfg, PRESET, n_slots=SLOTS, prompt_len=PROMPT,
                     gen_len=GEN, requests=REQUESTS, load="open",
                     smoke=False, device="cuda", dtype="fp32")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("serve report (mamba, open):", json.dumps(rep))
    log("launches (mamba, open):", counts)
    log(f"mamba path: peak device memory {peak / 1e9:.3f} GB "
        f"(max_memory_allocated)")
    if rep["requests"] != REQUESTS or rep["total_tokens"] != REQUESTS * GEN:
        raise AssertionError(f"mamba path: {rep['requests']} requests, "
                             f"{rep['total_tokens']} tokens; want "
                             f"{REQUESTS} x {GEN}")
    admissions = REQUESTS + 1                    # run_engine's warm-up too
    microsteps = counts.get("slot_decode", 0) / n_attn
    forwards = admissions + microsteps
    want = {"mamba_scan": n_mamba * admissions,
            "flash_attention": n_attn * admissions,
            "moe_route": n_moe * forwards,
            "rmsnorm": (2 * n_layers + 1) * forwards}
    for k, n in want.items():
        if counts.get(k, 0) != n:
            raise AssertionError(f"mamba path: {k} launched "
                                 f"{counts.get(k, 0)} times, want {n:g}")
    if microsteps < 1:
        raise AssertionError("mamba path: slot_decode never launched")
    launched = [k for k in PAGED_KERNELS + ("rwkv_scan",) if counts.get(k)]
    if launched:
        raise AssertionError(f"mamba path launched {launched}")
    log(f"mamba path: {admissions} admissions x {n_mamba} Mamba layers = "
        f"{counts['mamba_scan']} mamba_scan launches; {microsteps:g} decode "
        f"microsteps (warm-up included), none launching mamba_scan")
    return counts


def mamba_teacher_forced_phase(params, cfg, steps: int = 8,
                               tol: float = 2e-3):
    """Prefill 32 tokens, then ``steps`` slotted decode steps, at full
    width (one block) in fp32, kernels against plain versions on the card,
    both fed the plain path's greedy tokens. Gated: the kernel path
    replaying the plain path's routing (``routes``, as the MoE gate does:
    a near-tied 2nd/3rd expert flips on an ulp) and its layer inputs
    (``layer_inputs``, as the RWKV gate does: the random-init model at full
    width amplifies an ulp from layer to layer), max |dlogit| <= ``tol``;
    the prefill's final scan states and conv states are compared too.
    Printed, not gated: the kernel path on its own routing and inputs, and
    the plain path against itself with each forward's embedding output
    moved one ulp (``first_layer_nudged``)."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions, decode_step_slots, prefill
    from repro_torch.serve import slotify

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PROMPT),
                                         dtype=np.int32)).cuda()
    plain = ModelOptions(attn_impl="ref", dtype=torch.float32)
    kern = preset(PRESET).model_options(plain)

    def run(opts, hooks, feed=None):
        """Logits of the prefill and of each decode step and the prefill's
        Mamba states, with each forward under ``hooks()``; the tokens fed
        are ``feed``'s, or this run's own greedy ones."""
        with hooks():
            lg, cache = prefill(params, toks, cfg, opts, MAX_LEN)
        states = [g[k].clone() for g in cache if "ssm" in g
                  for k in ("ssm", "conv")]
        cache, out, fed = slotify(cache), [lg], []
        for i in range(steps):
            nxt = (feed[i] if feed is not None
                   else torch.argmax(lg, -1).to(torch.int32))
            fed.append(nxt)
            with hooks():
                lg, cache = decode_step_slots(params, cache, nxt, cfg, opts)
            out.append(lg)
        return out, states, fed

    def worst(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    route_log, input_log = [], []

    @contextlib.contextmanager
    def record():
        with routes(route_log, False), layer_inputs(input_log, False):
            yield

    lp, sp, feed = run(plain, record)
    replayed = (iter(route_log), iter(input_log))

    @contextlib.contextmanager
    def replay():
        with routes(replayed[0], True), layer_inputs(replayed[1], True):
            yield

    lk, sk, _ = run(kern, replay, feed)
    lf, sf, _ = run(kern, contextlib.nullcontext, feed)
    ln, sn, _ = run(plain, lambda: first_layer_nudged(cfg.num_layers), feed)
    torch.cuda.synchronize()
    w = worst(lp, lk)
    log(f"teacher-forced (mamba, fp32, prefill + {steps} slotted decode "
        f"steps, routing and layer inputs replayed) max |dlogit|: {w:.3e} "
        f"(tolerance {tol}; logit scale {lp[-1].abs().max().item():.3g}); "
        f"prefill scan and conv states max |error| {worst(sp, sk):.3e} over "
        f"{len(sp) // 2} Mamba layers (state scale "
        f"{max(t.abs().max().item() for t in sp):.3g})")
    for name, logits, states in (
            ("mamba kernel path on its own routing and inputs", lf, sf),
            ("mamba plain path, embedding output moved one ulp", ln, sn)):
        log(f"{name}: max |dlogit| {worst(lp, logits):.4e}, prefill states "
            f"max |error| {worst(sp, states):.4e} (not gated)")
    if not math.isfinite(w) or w > tol:
        raise AssertionError(f"teacher-forced (mamba) logits differ by {w}")


def mamba_profile_phase(params, cfg):
    """Where one Mamba engine run's time goes: 4 slots, each admitted with
    a 32-token prompt, then one 32-step L3 program, fp32, ``nss_shortcut``:
    wall time, device busy, idle share, the top kernels (the GEMMs first),
    and the scan, router, attention and norm kernels by name."""
    import dataclasses

    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions
    from repro_torch.serve import ServeEngine, synthetic_requests

    lk = dataclasses.replace(preset(PRESET), decode_steps=GEN)
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=torch.float32))
    reqs = synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size, seed=7)
    eng = ServeEngine(cfg, params, opts, lk, n_slots=SLOTS, max_len=MAX_LEN)
    _profile_run(f"mamba slotted: {SLOTS} admissions + one {GEN}-step decode "
                 "program, fp32, 1 of 4 blocks", eng, reqs,
                 also=("mamba", "route", "decode", "flash", "rmsnorm"))


def mamba_phases(check: bool = True):
    """The Mamba path, then its teacher-forced check (``check``) and its
    profile over one seeded set of fp32 parameters (53.2 GB; the path
    phase's own are freed first). Returns the path's launch counts."""
    import torch
    from repro_torch.models import init_params

    _release()
    counts = mamba_path_phase()
    _release()
    cfg = mamba_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if check:
        mamba_teacher_forced_phase(params, cfg)
    mamba_profile_phase(params, cfg)
    del params
    _release()
    return counts


# ---------------------------------------------------------------------------
# the model zoo's remainder at full width (paths Z1-Z7)
# ---------------------------------------------------------------------------

#: (path, arch, blocks kept or None for all, dtype, what runs): every path
#: at its config's published widths; depth cut where 80 GB or the run's
#: time limit forces it
ZOO = (("Z1", "qwen2-7b", 8, "fp32", "paged"),
       ("Z2", "h2o-danube-1.8b", 8, "fp32", "window"),
       ("Z3", "llama-3.2-vision-11b", None, "fp32", "xattn"),
       ("Z4", "musicgen-medium", None, "fp32", "embeds"),
       ("Z5", "mixtral-8x7b", 8, "bf16", "slotted"),
       ("Z6", "mistral-large-123b", 8, "bf16", "paged"),
       ("Z7", "kimi-k2-1t-a32b", 1, "bf16", "slotted"))
#: Z2: requests of 4,128 prompt tokens (past danube's 4,096-token window)
#: and of 32, each with 32 new tokens; max_len 4,224
ZOO_LONG, ZOO_LONG_MAX_LEN = 4128, 4224
#: the zoo's bound on teacher-forced |dlogit| (PERF.md section 2)
ZOO_TOL = 2e-3


def _zoo_dtype(name):
    import torch
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[name]


def zoo_model(arch, blocks, dtype):
    """The config (cut to ``blocks`` blocks when given) and its seeded
    parameters on the card in ``dtype``; the QKV biases of a config that
    has them drawn nonzero (N(0, 0.1²); the init's are zero, which would
    hide them)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_blocks=blocks) if blocks else full
    size = cfg.param_count() * _zoo_dtype(dtype).itemsize
    log(f"zoo {arch}: full width, {cfg.num_layers} of {full.num_layers} "
        f"layers ({'depth cut' if blocks else 'full depth'}), "
        f"{cfg.param_count() / 1e9:.4f} B of {full.param_count() / 1e9:.4f} "
        f"B parameters, {size / 1e9:.2f} GB in {dtype}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda", param_dtype=_zoo_dtype(dtype))
    if cfg.attn_bias:
        for layer in params["layers"]:
            for name in ("bq", "bk", "bv"):
                b = layer["mixer"][name]
                b.copy_(torch.randn(b.shape, generator=gen, device="cuda")
                        * 0.1)
    return cfg, params


def zoo_serve(path, cfg, params, dtype, kind, want, never):
    """One engine path as ``run_engine`` makes it (a warm run through the
    same programs, counters reset), ``nss_shortcut``, 4 slots, open load:
    paged ("paged": path A's 8 requests of 32 + 32 sharing a 16-token
    prefix, blocks of 16), or slotted (8 requests of 32 + 32; Z2: 2 of
    4,128 + 32 and 2 of 32 + 32, max_len 4,224). Launch counts zeroed
    just before the timed run and read just after: every kernel of
    ``want`` must launch, none of ``never``; every request must finish
    with its budget. Prints the report, tokens/s and peak memory; then
    profiles the engine (``_profile_run``: one wave of 4 requests, 32 + 33
    tokens, or Z2's two long and two short prompts, then decode); returns
    the counts."""
    import dataclasses

    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions
    from repro_torch.serve import ServeEngine, serve_report
    from repro_torch.serve import synthetic_requests

    lk = preset(PRESET)
    lk = dataclasses.replace(lk, decode_steps=min(lk.decode_steps, GEN))
    opts = lk.model_options(ModelOptions(attn_impl="ref",
                                         dtype=_zoo_dtype(dtype)))
    paged = kind == "paged"
    shared = SHARED if paged else 0
    max_len = ZOO_LONG_MAX_LEN if kind == "window" else MAX_LEN
    kw = dict(kv="paged", block_size=BS) if paged else {}
    eng = ServeEngine(cfg, params, opts, lk, n_slots=SLOTS, max_len=max_len,
                      **kw)
    eng.run(synthetic_requests(2 if shared else 1, PROMPT,
                               eng.tokens_per_program + 1, cfg.vocab_size,
                               seed=1, shared_prefix_len=shared),
            load="closed")
    if paged:
        eng.kv.drop_prefix_cache()
    eng.reset_counters()
    if kind == "window":
        reqs = synthetic_requests(4, PROMPT, GEN, cfg.vocab_size, seed=0,
                                  rate=25.0, prompt_lens=(ZOO_LONG, PROMPT))
    else:
        reqs = synthetic_requests(REQUESTS, PROMPT, GEN, cfg.vocab_size,
                                  seed=0, rate=25.0, shared_prefix_len=shared)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comps, wall = eng.run(reqs, load="open")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rep = serve_report(comps, wall, eng.utilization())
    log(f"zoo {path} serve report:", json.dumps(rep))
    log(f"zoo {path} launches:", counts)
    log(f"zoo {path}: {cfg.name}, {rep['tokens_per_s']:.6g} tokens/s, peak "
        f"device memory {peak / 1e9:.3f} GB (max_memory_allocated)")
    got = {c.rid: len(c.tokens) for c in comps}
    short = [r.rid for r in reqs if got.get(r.rid) != r.max_new_tokens]
    if short:
        raise AssertionError(f"zoo {path}: requests {short} did not finish "
                             "with their budget")
    for k in want:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"zoo {path}: kernel {k} was never launched")
    launched = [k for k in never if counts.get(k)]
    if launched:
        raise AssertionError(f"zoo {path} launched {launched}")
    wave = (synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size, seed=7,
                               prompt_lens=(ZOO_LONG, PROMPT))
            if kind == "window" else
            synthetic_requests(SLOTS, PROMPT, GEN + 1, cfg.vocab_size, seed=7))
    _profile_run(f"zoo {path} {cfg.name}, {kind}, {dtype}", eng, wave,
                 also=("flash", "decode_split", "route", "rmsnorm"))
    if cfg.moe is not None:
        per_forward = cfg.num_layers
        forwards = (counts["flash_attention"]
                    + counts.get("slot_decode", 0)) / cfg.num_layers
        if counts["moe_route"] != per_forward * forwards:
            raise AssertionError(f"zoo {path}: moe_route launched "
                                 f"{counts['moe_route']} times, want "
                                 f"{per_forward * forwards:g} (one a layer "
                                 "of every forward)")
    return counts


def _zoo_inputs(cfg, B, S):
    """Seeded inputs of S positions on the card: token ids (B, S), or frame
    embeddings (B, S, D) x 0.1 for an ``embeds_in`` model; and a
    cross-attention context (B, ctx_len, ctx_dim) x 0.1, or None."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    if cfg.embeds_in:
        x = torch.from_numpy((rng.standard_normal((B, S, cfg.d_model))
                              * 0.1).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                          dtype=np.int32))
    xctx = None
    if cfg.xattn_ctx_len:
        xctx = torch.from_numpy((rng.standard_normal(
            (B, cfg.xattn_ctx_len, cfg.xattn_ctx_dim)) * 0.1).astype(
                np.float32)).cuda()
    return x.cuda(), xctx


def zoo_teacher_forced(path, cfg, params, kind, steps: int = 8,
                       tol: float = ZOO_TOL):
    """Teacher-forced logits, kernel path against plain path on the same
    weights, float32 activations (over bf16 parameters where the path's
    are bf16, each weight cast on use, as the MoE path's check): a prefill
    of B 2 x 32 positions, then ``steps`` decode steps fed the plain
    path's greedy tokens (musicgen: the next seeded frames) through the
    slotted step (musicgen: the uniform one), and on the paged paths also
    through the paged step over a pool filled by the prefill through a
    permuted table. The kernel path replays the plain path's MoE routing
    (``routes``: a near-tied expert flips on an ulp). max |dlogit| <=
    ``tol``. Launch counts are zeroed before the kernel path's first run and
    read after it: the model-level paths' (Z3, Z4) counts."""
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import (ModelOptions, decode_step,
                                    decode_step_paged, decode_step_slots,
                                    prefill)
    from repro_torch.models.transformer import clone_cache
    from repro_torch.serve import slotify
    from repro_torch.serve.paging import init_paged_cache, scatter_kv

    B = 2
    x, xctx = _zoo_inputs(cfg, B, PROMPT + steps)
    plain = ModelOptions(attn_impl="ref", dtype=torch.float32)
    kern = preset(PRESET).model_options(plain)
    P = 3 * NB * B
    table = torch.randperm(P, generator=torch.Generator().manual_seed(1))[
        :NB * B].to(torch.int32).reshape(B, NB).cuda()

    def paged_from(c):
        pc = init_paged_cache(cfg, P, BS, B, torch.float32, "cuda")
        p = torch.arange(PROMPT, device="cuda")
        for b in range(B):
            scatter_kv(pc, [{"k": g["k"][b:b + 1, :PROMPT],
                             "v": g["v"][b:b + 1, :PROMPT]} for g in c],
                       table[b, p // BS].long(), p % BS, b, PROMPT)
        return pc

    modes = {"slotted": (decode_step_slots, slotify)}
    if kind == "embeds":
        modes = {"uniform": (decode_step, lambda c: c)}
    if kind == "paged":
        modes["paged"] = (lambda p, c, t, cf, o: decode_step_paged(
            p, c, t, table, cf, o, MAX_LEN), paged_from)

    def run(opts, route_log, replay, feed=None):
        with routes(route_log, replay):
            lg, cache = prefill(params, x[:, :PROMPT], cfg, opts, MAX_LEN,
                                xctx=xctx)
        out = {}
        for mode, (step, layout) in modes.items():
            c, lgs, fed, lm = layout(clone_cache(cache)), [lg], [], lg
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                if kind == "embeds":
                    nxt = x[:, PROMPT + i]
                else:
                    nxt = (feed[mode][i] if feed is not None
                           else torch.argmax(lm, -1).to(torch.int32))
                fed.append(nxt)
                with routes(route_log, replay):
                    lm, c = step(params, c, nxt, cfg, opts)
                lgs.append(lm)
            torch.cuda.synchronize()
            out[mode] = (lgs, fed, B * steps / (time.perf_counter() - t0))
        return out

    plain_log = []
    lp = run(plain, plain_log, replay=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lk = run(kern, iter(plain_log), replay=True,
             feed={m: fed for m, (_, fed, _) in lp.items()})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for mode in modes:
        w = max((a - b).abs().max().item()
                for a, b in zip(lp[mode][0], lk[mode][0]))
        log(f"zoo {path} teacher-forced ({cfg.name}, f32 activations, "
            f"prefill B {B} x {PROMPT} + {steps} {mode} decode steps"
            f"{', routing replayed' if cfg.moe else ''}) max |dlogit|: "
            f"{w:.3e} (tolerance {tol}; logit scale "
            f"{lp[mode][0][-1].abs().max().item():.3g}); the kernel path's "
            f"decode {lk[mode][2]:.6g} tokens/s (B {B}, one token a step "
            "and a sync, not an engine's rate)")
        if not math.isfinite(w) or w > tol:
            raise AssertionError(f"zoo {path} teacher-forced ({mode}) logits "
                                 f"differ by {w}")
    return counts


def zoo_window_phase(path, cfg, params, tol: float = ZOO_TOL):
    """The window binds (JAX's ``test_swa_decode_past_window`` at full
    width): one seeded sequence of 4,160 tokens; the kernel path prefills
    its first 4,128 (the 4,096-key circular buffer rolls) and decodes the
    last 32 through the slotted step, fed the sequence's own tokens
    (decode runs past the window); the plain path does the same, and a
    plain full-sequence prefill of all 4,160 positions masks the keys past
    the window. Gated, each max |dlogit| <= ``tol``: the kernel path's
    logits against the plain path's at the prefill and every decode step,
    and the kernel path's last step (position 4,159) against the full
    prefill's last position, which agree only if the window is right."""
    import torch
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions, decode_step_slots, prefill
    from repro_torch.serve import slotify

    n = ZOO_LONG + GEN
    toks, _ = _zoo_inputs(cfg, 1, n)
    plain = ModelOptions(attn_impl="ref", dtype=torch.float32)
    kern = preset(PRESET).model_options(plain)

    def run(opts):
        lg, cache = prefill(params, toks[:, :ZOO_LONG], cfg, opts,
                            ZOO_LONG_MAX_LEN)
        cache, out = slotify(cache), [lg]
        for i in range(ZOO_LONG, n):
            lg, cache = decode_step_slots(params, cache, toks[:, i], cfg,
                                          opts)
            out.append(lg)
        return out

    lp, lk = run(plain), run(kern)
    full, _ = prefill(params, toks, cfg, plain, ZOO_LONG_MAX_LEN)
    torch.cuda.synchronize()
    w = max((a - b).abs().max().item() for a, b in zip(lp, lk))
    wf = (lk[-1] - full).abs().max().item()
    log(f"zoo {path} teacher-forced ({cfg.name}, fp32, prefill {ZOO_LONG} + "
        f"{GEN} slotted decode steps past the {cfg.sliding_window}-token "
        f"window) max |dlogit|: {w:.3e}; the kernel path's last step vs a "
        f"plain full prefill of {n} positions: {wf:.3e} (tolerance {tol}; "
        f"logit scale {full.abs().max().item():.3g}); the plain path's: "
        f"{(lp[-1] - full).abs().max().item():.3e}")
    for what, e in (("kernel vs plain", w), ("decode past the window vs "
                                             "full prefill", wf)):
        if not math.isfinite(e) or e > tol:
            raise AssertionError(f"zoo {path} ({what}) logits differ by {e}")


def zoo_phase():
    """Paths Z1-Z7: each config of the zoo's remainder at its published
    widths on the card, one at a time (the last one's tensors released
    first): Z1 qwen2-7b (8 of 28 layers, fp32, nonzero QKV biases, G 7) and Z6
    mistral-large-123b (8 of 88 layers, bf16, G 12, D 12288) through the
    paged engine as path A; Z2 h2o-danube-1.8b (8 of 24 layers, fp32, dh 80)
    through the slotted engine with prompts past its 4,096-token window,
    and the window check (``zoo_window_phase``); Z5 mixtral-8x7b (8 of
    32 layers, bf16, E 8, k 2) and Z7 kimi-k2-1t-a32b (1 of 61 layers,
    bf16, E 384, k 8, dh 112) through the slotted engine; Z3
    llama-3.2-vision-11b (40 layers, fp32, every ``xgate`` set to 1.0:
    the init's zero hides the cross-attention) and Z4 musicgen-medium (48
    layers, fp32, frame embeddings) at model level, which is all the
    engine takes of them, as in JAX. Each path's kernels against its plain
    path teacher-forced (``zoo_teacher_forced``); every kernel of the path
    launched. Returns each path's launch counts."""
    import torch
    counts_by = {}
    for path, arch, blocks, dtype, kind in ZOO:
        t0 = time.time()
        _release()
        cfg, params = zoo_model(arch, blocks, dtype)
        want = ("rmsnorm", "flash_attention",
                "paged_decode" if kind == "paged" else "slot_decode")
        if cfg.moe is not None:
            want += ("moe_route",)
        if kind in ("paged", "window", "slotted"):
            never = (("slot_decode", "paged_decode_quant",
                      "paged_prefill_quant") if kind == "paged"
                     else PAGED_KERNELS)
            counts = zoo_serve(path, cfg, params, dtype, kind, want, never)
            _release()
        if kind == "window":
            zoo_window_phase(path, cfg, params)
        else:
            if kind == "xattn":
                for layer in params["layers"]:
                    if "xgate" in layer["mixer"]:
                        layer["mixer"]["xgate"].fill_(1.0)
            torch.cuda.reset_peak_memory_stats()
            tf_counts = zoo_teacher_forced(path, cfg, params, kind)
            if kind in ("xattn", "embeds"):
                counts = tf_counts
                log(f"zoo {path} launches (the kernel path's runs):", counts)
                log(f"zoo {path}: {cfg.name}, peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
                    "(max_memory_allocated)")
                for k in want:
                    if counts.get(k, 0) < 1:
                        raise AssertionError(f"zoo {path}: kernel {k} was "
                                             "never launched")
        counts_by[path] = counts
        del params
        log(f"zoo {path} ({arch}) done in {time.time() - t0:.1f} s")
    _release()
    return counts_by


# ---------------------------------------------------------------------------
# training: the flash backward kernel and the train path (TR1-TR3)
# ---------------------------------------------------------------------------

#: TR1: full-width, full-depth tinyllama-1.1b in fp32 through the training
#: launcher at nss_shortcut (4 steps a call): 8 steps of 4 x 1,024 tokens
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = (
    "tinyllama-1.1b", 8, 4, 1024, 1e-3)
#: TR2: the kernel path against the plain path at full width, TR2_LAYERS
#: layers, from one init and one batch stream, TR2_STEPS steps gated and
#: TR2_RUN run (the rest printed: they follow TR1's steps 5-8).
#: Tolerances (fixed before the first run on the card): the step-1 loss
#: (absolute), the step-1 gradient norm (relative), every parameter's max
#: |dgrad| over its max |grad|, and the losses of steps 2 on within 10 x
#: lr: AdamW's first steps move a parameter by about lr x sign(g), and a
#: gradient of rounding-noise size may take the other sign on the other
#: path
TR2_LAYERS, TR2_STEPS, TR2_RUN = MAIN_BLOCKS, 4, 8
TR2_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "grad": 1e-3,
           "losses": 10 * TRAIN_LR}
#: TR3: full width cut to 2 layers (a checkpoint of 2.6 GB: params and
#: two moments), L2 with the shortcut, 8 steps, a checkpoint every 4, a
#: failure injected at step 6
TR3_LAYERS, TR3_STEPS, TR3_CKPT, TR3_FAIL = 2, 8, 4, 6
#: the backward kernel's cases: label, B, S, HQ, HKV, dh, window (all
#: causal); the train path's shape first
FLASH_BWD_CASES = (
    ("main", 4, 1024, 32, 4, 64, 0),
    ("qwen2 G 7", 1, 1024, 28, 4, 128, 0),
    ("kimi dh 112", 1, 1024, 64, 8, 112, 0),
    ("danube window 4096", 1, 4128, 32, 8, 80, 4096),
    ("ragged S 1", 2, 1, 32, 4, 64, 0),
    ("ragged S 7", 2, 7, 32, 4, 64, 0),
    ("ragged S 129", 2, 129, 28, 4, 128, 0),
    ("ragged dh 80 window 100", 2, 333, 32, 8, 80, 100),
    ("ragged dh 112 S 100", 1, 100, 16, 2, 112, 0),
    # the training mesh's local shapes (checked, not timed)
    ("mesh train 2x1", 2, 1024, 32, 4, 64, 0),
    ("mesh train 1x2", 4, 1024, 16, 2, 64, 0),
)
#: max |kernel - plain| of dq, dk, dv over the largest |grad| of the three
#: (at least 1): fp32 sums in another order; a bf16 kernel rounds its
#: outputs once (2^-9 relative), held against the plain backward of the
#: same values in fp32
BWD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
#: the backward's CUDA kernels, by the name each record carries
BWD_LAUNCHES = ("flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_reduce")


def bwd_chunk_phase(gen):
    """The dkdv chunk's trade-off (``bwd_geometry``): at the timed cases
    of FLASH_BWD_CASES, fp32 and bf16, the backward's device ms by launch
    under the chunk the geometry picks and under forced chunks (one step
    a block up to one chunk a key tile), with the blocks and waves each
    makes on this card."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, S, HQ, HKV, dh, window in FLASH_BWD_CASES:
            if label.startswith("ragged"):
                continue

            def rn(*shape):
                return torch.randn(*shape, generator=gen,
                                   device="cuda").to(dtype)
            q, k, v = rn(B, S, HQ, dh), rn(B, S, HKV, dh), rn(B, S, HKV, dh)
            do = rn(B, S, HQ, dh)
            with torch.no_grad():
                o, lse = kfa.flash_attention_with_lse(q, k, v, causal=True,
                                                      window=window)
            slots = kfa._bwd_slots(dtype, kfa.bwd_head_dim(dh),
                                   torch.cuda.current_device())
            picked = kfa.bwd_geometry(B, S, HQ, HKV, dh, True, window, dtype,
                                      slots)
            most = max(kfa.bwd_steps(S, HQ // HKV, True, window,
                                     picked.bqs))
            chunks = sorted({picked.chunk, 1, 2, 4, 8, 16, 32, 64, most,
                             -(-most // 2), -(-most // 4)} - {0})
            for c in chunks:
                if c > most:
                    continue
                geo = kfa.bwd_geometry(B, S, HQ, HKV, dh, True, window,
                                       dtype, slots, chunk=c)

                def call():
                    return kfa.flash_attention_bwd(
                        q, k, v, o, do, lse, causal=True, window=window,
                        _chunk=c)
                *_, by = kernel_device_ms(
                    call, "flash_attention_bwd", 10, symbol="flash_bwd",
                    cuda_launches=geo.launches, parts=BWD_LAUNCHES)
                blocks = geo.chunks * B * HKV
                log(f"bwd chunk {str(dtype):15s} {label:20s} chunk {c:4d}"
                    f"{' (picked)' if c == picked.chunk else '         '} "
                    f"blocks {blocks:6d} waves {blocks / slots:6.2f} "
                    f"device {sum(by.values()):.5f} ms: " + " ".join(
                        f"{kk} {vv:.5f}" for kk, vv in by.items()))
            del q, k, v, o, lse, do
    _release()


def flash_bwd_phase(gen):
    """``flash_attention_bwd`` against the plain backward
    (``flash_attention_bwd_ref``: autograd through the plain attention),
    on every case of FLASH_BWD_CASES in fp32 and bf16, ``o`` and ``lse``
    from the forward kernel (``flash_attention_with_lse``); a bf16 case's
    plain backward runs on the same values widened to fp32. Gated: the
    forward's ``o`` bit-identical with the lse pointer set and null
    (serving's), its lse against the plain one (``flash_attention_ref(...,
    return_lse=True)`` on the widened values) within TOL of max(1, |lse|),
    two runs of the backward bit-identical, the gradients within BWD_TOL,
    and (first case) a CUDA call without lse raising. Timed but for the
    ragged cases: the kernel (``ms``; ``device_ms`` and ``device_mean_ms``
    over its 2 or 3 CUDA launches by ``kernel_device_ms``; each launch's
    apart), the forward with and without lse (device), the plain backward
    in the working dtype, the forward and backward kernels through the
    autograd ``Function``, SDPA's forward and backward through autograd
    and its forward alone (their difference the backward's library
    yardstick; the port never calls SDPA) and the bound (bytes: q,
    k, v, o, do read and dq, dk, dv written once; operations: 10 dh a
    live (query, key) pair and head -- the scores, dP and the three
    gradient products). Over an older tree (``compare``), without
    ``flash_attention_with_lse``, the lse gates are skipped and the
    backward is called as that tree takes it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    # ``compare`` runs this over an older tree too, whose forward writes no
    # lse and whose backward takes none
    has_lse = hasattr(kfa, "flash_attention_with_lse")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, S, HQ, HKV, dh, window in FLASH_BWD_CASES:
            def rn(*shape):
                return torch.randn(*shape, generator=gen,
                                   device="cuda").to(dtype)
            q, k, v = rn(B, S, HQ, dh), rn(B, S, HKV, dh), rn(B, S, HKV, dh)
            do = rn(B, S, HQ, dh)
            name = f"flash_attention_bwd [{label}] {dtype}"
            with torch.no_grad():
                o_serve = kfa.flash_attention(q, k, v, causal=True,
                                              window=window)
                o, lse = (kfa.flash_attention_with_lse(
                    q, k, v, causal=True, window=window) if has_lse
                    else (o_serve, None))
            lse_err = None
            if has_lse:
                _, lse_want = ref.flash_attention_ref(
                    q.float(), k.float(), v.float(), causal=True,
                    window=window, return_lse=True)
                torch.cuda.synchronize()
                if not torch.equal(o, o_serve):
                    raise AssertionError(f"{name}: the forward's o differs "
                                         f"with the lse pointer set")
                lse_err = (lse - lse_want).abs().max().item()
                lse_top = max(lse_want.abs().max().item(), 1.0)
                if (not torch.isfinite(lse).all().item()
                        or lse_err > TOL[str(dtype)] * lse_top):
                    raise AssertionError(f"{name}: the forward's lse is off "
                                         f"by {lse_err} (largest |lse| "
                                         f"{lse_top:.3e})")
                del lse_want
                if not rows:
                    try:
                        kfa.flash_attention_bwd(q, k, v, o, do, causal=True,
                                                window=window)
                    except ValueError:
                        pass
                    else:
                        raise AssertionError(f"{name}: no lse, and no "
                                             f"raise")

            def call():
                if not has_lse:    # an older tree: the backward recomputes it
                    return kfa.flash_attention_bwd(q, k, v, o, do,
                                                   causal=True, window=window)
                return kfa.flash_attention_bwd(q, k, v, o, do, lse,
                                               causal=True, window=window)
            got, again = call(), call()
            want = ref.flash_attention_bwd_ref(
                q.float(), k.float(), v.float(), do.float(), causal=True,
                window=window)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two runs differ")
            errs = [(g.float() - w).abs().max().item()
                    for g, w in zip(got, want)]
            top = max(max(w.abs().max().item() for w in want), 1.0)
            tol = BWD_TOL[str(dtype)]
            if (not all(torch.isfinite(g).all().item() for g in got)
                    or max(errs) > tol * top):
                raise AssertionError(f"{name}: kernel disagrees with the "
                                     f"plain backward (max |d| dq, dk, dv "
                                     f"{errs}, largest |grad| {top:.3e}, "
                                     f"tolerance {tol} of it)")
            i = torch.arange(S, device="cuda")
            live = i[:, None] >= i[None, :]
            if window:
                live &= i[:, None] - i[None, :] < window
            pairs = int(live.sum().item()) * B * HQ
            geo = kfa.bwd_geometry(
                B, S, HQ, HKV, dh, True, window, dtype,
                kfa._bwd_slots(dtype, kfa.bwd_head_dim(dh),
                               torch.cuda.current_device())) \
                if has_lse else None
            row = {"label": label, "dtype": str(dtype),
                   "max_abs_err": max(errs), "dq_dk_dv_err": errs,
                   "max_abs_grad": top, "lse_err": lse_err,
                   "deterministic": True,
                   "geometry": geo and geo._asdict(),
                   "shape": f"q ({B},{S},{HQ},{dh}), kv ({B},{S},{HKV},"
                            f"{dh}), window {window}"}
            if not label.startswith(("ragged", "mesh")):
                b_ms, b_by = bound(nbytes(q, k, v, o, do, q, k, v),
                                   10.0 * dh * pairs, dtype)
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                qT, kT, vT = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (q, k, v))
                doT = do.transpose(1, 2)
                mask = live if window else None

                def fwd_bwd():
                    out = kfa.flash_attention(qg, kg, vg, causal=True,
                                              window=window)
                    return torch.autograd.grad(out, (qg, kg, vg), do)

                def lib():
                    out = F.scaled_dot_product_attention(
                        qT, kT, vT, attn_mask=mask, is_causal=mask is None,
                        enable_gqa=True)
                    return torch.autograd.grad(out, (qT, kT, vT), doT)

                def lib_fwd():
                    with torch.no_grad():
                        return F.scaled_dot_product_attention(
                            qT, kT, vT, attn_mask=mask,
                            is_causal=mask is None, enable_gqa=True)

                def fwd():
                    with torch.no_grad():
                        return kfa.flash_attention(q, k, v, causal=True,
                                                   window=window)

                def fwd_lse():
                    if not has_lse:
                        return fwd()
                    with torch.no_grad():
                        return kfa.flash_attention_with_lse(
                            q, k, v, causal=True, window=window)

                def plain():
                    return ref.flash_attention_bwd_ref(
                        q, k, v, do, causal=True, window=window)
                # an older tree's backward made two launches
                dev, dev_mean, by = kernel_device_ms(
                    call, "flash_attention_bwd", 10, symbol="flash_bwd",
                    cuda_launches=geo.launches if geo else 2,
                    parts=BWD_LAUNCHES)
                row["launch_device_ms"] = by
                row.update(ms=cuda_ms(call, 10, 2), device_ms=dev,
                           device_mean_ms=dev_mean,
                           fwd_device_ms=device_ms(fwd, 10,
                                                   only="flash_fwd"),
                           fwd_lse_device_ms=device_ms(fwd_lse, 10,
                                                       only="flash_fwd"),
                           fwd_bwd_ms=cuda_ms(fwd_bwd, 10, 2),
                           plain_ms=cuda_ms(plain, 5, 1),
                           library_ms=cuda_ms(lib, 10, 2),
                           library_device_ms=device_ms(lib, 10),
                           library_fwd_ms=cuda_ms(lib_fwd, 10, 2),
                           library_fwd_device_ms=device_ms(lib_fwd, 10),
                           bound_ms=b_ms, bound_by=b_by)
                row["library_bwd_ms"] = row["library_ms"] - row[
                    "library_fwd_ms"]
                if (row["library_device_ms"] is not None
                        and row["library_fwd_device_ms"] is not None):
                    row["library_bwd_device_ms"] = (
                        row["library_device_ms"]
                        - row["library_fwd_device_ms"])
                del qg, kg, vg, qT, kT, vT
            log(f"kernel flash_attention_bwd {str(dtype):15s} {label:20s} "
                + " ".join(f"{k}={v!r}" for k, v in row.items()
                           if k not in ("label", "dtype")))
            rows.append(row)
            del q, k, v, o, o_serve, lse, do, got, again, want
    _release()
    return rows


def grad_guard_phase():
    """Every serving kernel wrapper, given a CUDA input that requires grad
    with grad mode on, raises (their kernels have no backward): slot and
    uniform decode, paged decode and paged prefill (fp32 and int8 pools),
    the router and both scans."""
    import torch
    from repro_torch.kernels import ops
    dev = "cuda"

    def rn(*shape, grad=False):
        return torch.randn(*shape, device=dev).requires_grad_(grad)

    B, T, HQ, HKV, dh, bs, nb = 2, 16, 8, 2, 64, 8, 2
    q = rn(B, 1, HQ, dh, grad=True)
    kv = rn(B, T, HKV, dh)
    pool = rn(B * nb + 1, bs, HKV, dh)
    i8 = torch.zeros(B * nb + 1, bs, HKV, dh, dtype=torch.int8, device=dev)
    sc = torch.ones(B * nb + 1, HKV, device=dev)
    tables = torch.arange(B * nb, dtype=torch.int32,
                          device=dev).reshape(B, nb)
    pos = torch.full((B,), 5, dtype=torch.int32, device=dev)
    slot_pos = torch.arange(T, dtype=torch.int32, device=dev)
    cases = {
        "slot_decode_attention": lambda: ops.slot_decode_attention(
            q, kv, kv, slot_pos[None].expand(B, T).contiguous(), pos),
        "decode_attention": lambda: ops.decode_attention(
            q, kv, kv, slot_pos, pos[0]),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q, pool, pool, tables, pos),
        "paged_decode_attention int8": lambda: ops.paged_decode_attention(
            q, i8, i8, tables, pos, sc, sc),
        "paged_prefill_attention": lambda: ops.paged_prefill_attention(
            rn(B, 4, HQ, dh, grad=True), pool, pool, tables, pos),
        "paged_prefill_attention int8": lambda: ops.paged_prefill_attention(
            rn(B, 4, HQ, dh, grad=True), i8, i8, tables, pos, sc, sc),
        "moe_route": lambda: ops.moe_route(rn(4, 256, grad=True),
                                           rn(256, 8), 2),
        "rwkv_scan": lambda: ops.rwkv_scan(
            rn(1, 4, 2, 16, grad=True), rn(1, 4, 2, 16), rn(1, 4, 2, 16),
            torch.rand(1, 4, 2, 16, device=dev), rn(2, 16)),
        "mamba_scan": lambda: ops.mamba_scan(
            rn(1, 4, 32, grad=True), torch.rand(1, 4, 32, device=dev),
            -torch.rand(32, 4, device=dev), rn(1, 4, 4), rn(1, 4, 4)),
    }
    for name, call in cases.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            log(f"grad guard: {name} raised: {e}")
            continue
        raise AssertionError(f"{name} took a grad-requiring CUDA input "
                             "without raising")
    return sorted(cases)


def train_path_phase():
    """TR1: ``python -m repro_torch.launch.train --arch tinyllama-1.1b
    --preset nss_shortcut`` through its ``main``, full width and depth,
    fp32, 4 steps a call, 8 steps of 4 x 1,024 tokens at lr 1e-3, the
    metrics read every call (``--sync-every 1``: each call's 4 microstep
    losses, ``step_losses``), no checkpoint inside the run. Launch counts
    are zeroed just before and read just after. Gates: every step's loss
    finite, step 8's below step 1's, flash forward and backward 22
    launches a step each, rmsnorm 45. Returns (the counts, the
    launcher's report)."""
    import os
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    _release()
    tmp = tempfile.mkdtemp(prefix="repro_torch_tr1_")
    try:
        report = os.path.join(tmp, "tr1.json")
        argv = ["--arch", TRAIN_ARCH, "--preset", "nss_shortcut",
                "--nss-steps", "4", "--global-batch", str(TRAIN_BATCH),
                "--seq-len", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
                "--lr", str(TRAIN_LR), "--ckpt-every", str(TRAIN_STEPS + 1),
                "--sync-every", "1", "--ckpt-dir", os.path.join(tmp, "ckpt"),
                "--report-json", report]
        log("TR1: python -m repro_torch.launch.train " + " ".join(argv))
        ops.reset_launch_counts()
        launch_train.main(argv)
        counts = ops.launch_counts()
        with open(report) as f:
            rep = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = rep["step_losses"]
    per_step = {k: n / TRAIN_STEPS for k, n in sorted(counts.items())}
    log(f"TR1: step losses {losses} (a call's last: {rep['losses']}), "
        f"tokens/s {rep['tokens_per_s']!r}, wall "
        f"{rep['wall_s']!r} s ({rep['wall_s'] / TRAIN_STEPS!r} s a step), "
        f"peak device memory {rep['peak_mem_gb']!r} GB; launches a step "
        f"{per_step}")
    if (len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses))
            or losses[-1] >= losses[0]):
        raise AssertionError(f"TR1: step losses {losses} (need {TRAIN_STEPS}"
                             ", finite, the last below the first)")
    want = {"flash_attention": 22, "flash_attention_bwd": 22, "rmsnorm": 45}
    for name, n in want.items():
        if counts.get(name, 0) != n * TRAIN_STEPS:
            raise AssertionError(f"TR1: {name} launched {counts.get(name)} "
                                 f"times over {TRAIN_STEPS} steps, want "
                                 f"{n} a step")
    return counts, rep


def _train_state(layers, steps):
    """Full-width tinyllama-1.1b cut to ``layers`` layers, its seeded init
    (the same every call), an AdamW config at TRAIN_LR and the data
    pipeline of TR1's shape."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import init_train_state
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_blocks=layers)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(cfg, ocfg, gen, "cuda")
    return cfg, ocfg, state, Pipeline(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ))


def train_compare_phase():
    """TR2: the kernel path (flash forward and backward kernels, the
    rmsnorm kernel) against the plain path (plain attention and norm
    through autograd) at full width, TR2_LAYERS layers, fp32, one seeded
    init and one batch stream. Step 1: the loss, the gradient norm and
    every parameter's max |dgrad| over its max |grad|, on the same
    params; then TR2_STEPS in-place steps of each path from the same init
    (re-made from the seed), their losses. Gated by TR2_TOL. Then one
    kernel-path step profiled (wall unprofiled, device busy, idle share,
    CUDA records) and one AdamW update profiled (its launches and device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree
    from repro_torch.core import make_train_step
    from repro_torch.data import stage
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions, loss_fn
    from repro_torch.optim import adamw
    _release()
    cfg, ocfg, state, pipe = _train_state(TR2_LAYERS, TRAIN_STEPS)
    batches = [stage(pipe.batch_at(i), "cuda") for i in range(TR2_RUN)]
    plain = ModelOptions(attn_impl="ref", scan_impl="ref",
                         dtype=torch.float32)
    kernel = ModelOptions(attn_impl="kernel", scan_impl="ref",
                          dtype=torch.float32, fused_norm=True)

    def loss_grads(opts):
        live = [p.detach().requires_grad_(True)
                for p in tree.leaves(state.params)]
        loss, _ = loss_fn(tree.unflatten(state.params, live), batches[0],
                          cfg, opts)
        return float(loss), torch.autograd.grad(loss, live)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    loss_k, grads_k = loss_grads(kernel)
    counts = ops.launch_counts()
    grads_k = [g.cpu() for g in grads_k]       # room for the plain path
    loss_p, grads_p = loss_grads(plain)
    peak = torch.cuda.max_memory_allocated() / 1e9
    norm = {n: math.sqrt(sum(float(g.double().square().sum()) for g in gs))
            for n, gs in (("kernel", grads_k), ("plain", grads_p))}
    rel = max(float((gk.cuda() - gp).abs().max())
              / max(float(gp.abs().max()), 1e-30)
              for gk, gp in zip(grads_k, grads_p))
    del grads_p
    out = {"layers": TR2_LAYERS, "loss_kernel": loss_k, "loss_plain": loss_p,
           "grad_norm_kernel": norm["kernel"],
           "grad_norm_plain": norm["plain"], "max_rel_grad_diff": rel,
           "step1_launches": counts, "peak_mem_gb_plain_step": peak}
    log(f"TR2 step 1 ({TR2_LAYERS} layers): {out}")
    if counts.get("flash_attention") != TR2_LAYERS or counts.get(
            "flash_attention_bwd") != TR2_LAYERS:
        raise AssertionError(f"TR2: the kernel path launched {counts}")
    if (abs(loss_k - loss_p) > TR2_TOL["loss"]
            or abs(norm["kernel"] - norm["plain"])
            > TR2_TOL["grad_norm"] * norm["plain"]
            or rel > TR2_TOL["grad"]):
        raise AssertionError(f"TR2: step 1 outside {TR2_TOL}: {out}")

    losses = {}
    for name, opts in (("kernel", kernel), ("plain", plain)):
        if name == "plain":
            del state
            _release()
            _, _, state, _ = _train_state(TR2_LAYERS, TRAIN_STEPS)
        step_fn = make_train_step(cfg, opts, ocfg, inplace=True)
        losses[name] = []
        for b in batches:
            state, m = step_fn(state, b)
            losses[name].append(float(m["loss"]))
    diffs = [abs(a - b) for a, b in zip(losses["kernel"], losses["plain"])]
    out.update(losses_kernel=losses["kernel"], losses_plain=losses["plain"],
               loss_diffs=diffs)
    log(f"TR2 {TR2_RUN} steps (lr schedule as TR1's): kernel "
        f"{losses['kernel']}, plain {losses['plain']}, |d| {diffs} "
        f"(the first {TR2_STEPS} gated at {TR2_TOL['losses']})")
    if max(diffs[:TR2_STEPS]) > TR2_TOL["losses"]:
        raise AssertionError(f"TR2: losses differ by {diffs}")

    # one kernel-path step: wall (unprofiled), device busy, idle share
    del state
    _release()
    _, _, state, _ = _train_state(TR2_LAYERS, TRAIN_STEPS)
    step_fn = make_train_step(cfg, kernel, ocfg, inplace=True)
    state, _ = step_fn(state, batches[0])           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step_fn(state, batches[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batches[2])
        torch.cuda.synchronize()
    ev = _device_events(prof)
    busy = sum(us for _, us in ev.values()) / 1e6
    records = sum(n for n, _ in ev.values())
    grads = tree.unflatten(state.params, [g.cuda() for g in grads_k])
    del grads_k
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        adamw.update(ocfg, grads, state.opt, state.params, inplace=True)
        torch.cuda.synchronize()
    opt_ev = _device_events(prof)
    out.update(step_wall_s=wall, step_busy_s=busy,
               step_idle_share=max(0.0, 1 - busy / wall),
               step_cuda_records=records,
               adamw_launches=sum(n for n, _ in opt_ev.values()),
               adamw_device_ms=sum(us for _, us in opt_ev.values()) / 1e3,
               step_top_kernels=sorted(
                   ((name, n, us / 1e3) for name, (n, us) in ev.items()),
                   key=lambda r: -r[2])[:8])
    log(f"TR2 profile: one kernel-path step wall {wall!r} s, busy {busy!r} "
        f"s, idle share {out['step_idle_share']!r}, {records} CUDA records; "
        f"one AdamW update {out['adamw_launches']} launches, "
        f"{out['adamw_device_ms']!r} device ms; top kernels (name, "
        f"records, ms): {out['step_top_kernels']}")
    del state, grads
    _release()
    return out


def train_recovery_phase():
    """TR3: the fault-tolerant driver on full-width tinyllama-1.1b cut to
    TR3_LAYERS layers, L2 with the shortcut (every step's loss read),
    TR3_STEPS steps of 4 x 1,024 tokens, a checkpoint every TR3_CKPT
    steps into a temporary directory, run clean and with a
    ``FailureInjector`` at step TR3_FAIL. Gates: one restart, and the
    failed run's losses bit-identical to the clean run's (steps 0-5, then
    the replay from the step-4 checkpoint, 4-11)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core import L2_BYP, LinkageConfig, build_train_step
    from repro_torch.models import ModelOptions
    from repro_torch.runtime import DriverConfig, FailureInjector, train
    _release()
    lk = LinkageConfig(level=L2_BYP, shortcut=True)
    opts = ModelOptions(attn_impl="kernel", scan_impl="ref",
                        dtype=torch.float32, fused_norm=True)
    runs = {}
    for name, inj in (("clean", None),
                      ("failed", FailureInjector(fail_at=(TR3_FAIL,)))):
        cfg, ocfg, state, pipe = _train_state(TR3_LAYERS, TR3_STEPS)
        step = build_train_step(cfg, opts, ocfg, lk)
        d = tempfile.mkdtemp(prefix="repro_torch_tr3_")
        t0 = time.time()
        try:
            runs[name] = train(step.fn, state, pipe, lk, DriverConfig(
                total_steps=TR3_STEPS, ckpt_every=TR3_CKPT, ckpt_dir=d,
                keep_ckpts=2), injector=inj)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        log(f"TR3 {name}: {time.time() - t0:.1f} s, restarts "
            f"{runs[name].restarts}, losses {runs[name].losses}")
        del state
        _release()
    clean, failed = runs["clean"].losses, runs["failed"].losses
    want = clean[:TR3_FAIL] + clean[TR3_FAIL // TR3_CKPT * TR3_CKPT:]
    if runs["failed"].restarts != 1 or failed != want:
        raise AssertionError(f"TR3: restarts {runs['failed'].restarts}, "
                             f"losses {failed} against {want}")
    return {"clean": clean, "failed": failed,
            "restarts": runs["failed"].restarts}


def train_phases(gen, rows=None):
    """The training phase: the backward kernel's cases (``rows``, when
    the full run has already run them, early, where the profiler keeps
    its records: ROADMAP M2), the serving wrappers' grad guard, TR1-TR3.
    TR1-TR3 each run whatever an earlier one's gate says; a failed gate
    raises at the end of the phase. Returns (the kernel rows, TR1's
    launch counts, the phase's summary)."""
    if rows is None:
        rows = flash_bwd_phase(gen)
    guarded = grad_guard_phase()
    failed, out = [], {}
    for name, fn in (("TR1", train_path_phase), ("TR2", train_compare_phase),
                     ("TR3", train_recovery_phase)):
        try:
            out[name] = fn()
        except AssertionError as e:
            failed.append(f"{name}: {e}")
            log(f"{name} FAILED: {e}")
            _release()
    if failed:
        raise AssertionError("; ".join(failed))
    counts, tr1 = out["TR1"]
    summary = {"TR1": {k: tr1[k] for k in ("losses", "step_losses",
                                           "tokens_per_s", "wall_s",
                                           "peak_mem_gb")},
               "TR2": out["TR2"], "TR3": out["TR3"], "grad_guard": guarded}
    log("train summary: " + json.dumps(summary, default=str))
    return rows, counts, summary


# ---------------------------------------------------------------------------
# training over a (data, model) mesh (MT1-MT3)
# ---------------------------------------------------------------------------

#: MT1: full-width tinyllama-1.1b cut to MT_LAYERS layers, fp32, TR1's
#: data (4 x 1,024 tokens), lr 1e-3, L2 with the shortcut's kernels; the
#: sharded step at 2x1 and 1x2 against the unsharded kernel path from one
#: seed over MT_STEPS steps, gated by TR2_TOL
MT_LAYERS, MT_STEPS = 4, 3
#: MT3: the launcher's rank entry (what ``--data-mesh 2`` runs in each
#: rank) in the 2x1 ranks, ret_byp_shortcut read every call, TR3's form
#: shorter: 2 layers, 4 steps, a checkpoint at step 2, a failure at step 3
#: on every rank. MT2 restores the clean run's step-2 checkpoint (saved
#: at 2x1) onto 1x2, which trains on to step 4, and onto one device
MT3_LAYERS, MT3_STEPS, MT3_CKPT, MT3_FAIL = TR3_LAYERS, 4, 2, 3
#: the kernels' launches a rank a forward and backward on the mesh
MT_LAUNCHES = {"flash_attention": MT_LAYERS,
               "flash_attention_bwd": MT_LAYERS,
               "rmsnorm": 2 * MT_LAYERS + 1}


def _file_equal(path, step, full) -> bool:
    """Whether a checkpoint's arrays equal ``full``'s leaves bit for bit
    (read leaf by leaf)."""
    import numpy as np
    import torch
    from repro_torch import tree
    with np.load(f"{path}/step_{step:08d}/arrays.npz") as z:
        for i, x in enumerate(tree.leaves(full)):
            a = torch.from_numpy(z[f"leaf_{i}"]).to(x.device)
            if a.dtype != x.dtype or not torch.equal(a, x):
                return False
    return True


def _mt3_launch(ckpt_dir, fail=()) -> dict:
    """The launcher's flags for MT3 (``launch/train.py: run``'s dict):
    --data-mesh 2, the checkpoints under ``ckpt_dir``."""
    import dataclasses

    from repro_torch.configs import get_config
    return dict(
        arch=dataclasses.replace(get_config(TRAIN_ARCH),
                                 num_blocks=MT3_LAYERS),
        preset="ret_byp_shortcut", steps=MT3_STEPS, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, lr=TRAIN_LR, smoke=False, scale=1.0,
        ckpt_dir=ckpt_dir, ckpt_every=MT3_CKPT, nss_steps=4, sync_every=1,
        data_mesh=2, device="cuda", report_json=None, fail_at=fail,
        digest=True)


def _mt3_rank(mesh, ckpt_dir):
    """MT3 in a 2x1 rank: the launcher's rank entry, clean (its
    checkpoints under ``ckpt_dir``/clean, MT2's) and with a failure, each
    rank's losses, restarts and final state's sha256."""
    import os

    from repro_torch.launch import train as launch_train
    out = {}
    for name, fail in (("clean", ()), ("failed", (MT3_FAIL,))):
        t = time.perf_counter()
        rep = launch_train.train_rank(mesh, _mt3_launch(
            os.path.join(ckpt_dir, name), fail))
        out[name] = dict(rep, seconds=time.perf_counter() - t)
    return out


def _mt2_rank(mesh, ckpt_dir):
    """MT2 in a 1x2 rank: the MT3 clean run's step-MT3_CKPT checkpoint
    (saved at 2x1), once committed, restored onto this mesh under the
    launcher's configuration, gathered and held against the file (rank
    0), then trained on to step MT3_STEPS."""
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import build_sharded_train_step, init_train_state
    from repro_torch.data import DataConfig, Pipeline, stage
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding.placement import train_shard
    from repro_torch.sharding.rules import gather
    deadline = time.monotonic() + 300
    while ckpt.latest_step(ckpt_dir) != MT3_CKPT:
        if time.monotonic() > deadline:
            raise TimeoutError("MT2: no checkpoint from the 2x1 mesh")
        time.sleep(0.5)
    kw = _mt3_launch(ckpt_dir)
    cfg, lk, opts, ocfg = launch_train._setup(kw)
    gen = torch.Generator(device="cuda").manual_seed(1)
    like = init_train_state(cfg, ocfg, gen, "cuda")
    fn, sspecs, bspecs = build_sharded_train_step(cfg, opts, ocfg, lk, mesh,
                                                  like, TRAIN_BATCH)
    pieces = train_shard(cfg, like, mesh, TRAIN_BATCH).state
    del like
    state = ckpt.restore(ckpt_dir, MT3_CKPT, pieces, sspecs, mesh)
    del pieces
    full = gather(state, sspecs, mesh)
    out = {"restored_equal": (_file_equal(ckpt_dir, MT3_CKPT, full)
                              if mesh.rank == 0 else None)}
    del full
    pipe = Pipeline(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ))
    out["resumed_losses"] = []
    for i in range(MT3_CKPT, MT3_STEPS):
        state, m = fn(state, stage(pipe.batch_at(i), "cuda", bspecs, mesh))
        out["resumed_losses"].append(float(m["loss"]))
    out["resumed_step"] = int(state.step)
    return out


def _mesh_train_rank(mesh, ckpt_dir):
    """One rank of ``mesh_train_phase`` (``spawn``'s entry, in a process
    of its own): MT1 on this mesh (the unsharded kernel path first, on
    this rank: step 1's loss and gradient, this rank's pieces of it kept,
    then MT_STEPS in-place steps; then the sharded step from the same
    init: step 1's gradient held against those pieces, then applied, and
    the steps after), then MT3 at 2x1 and MT2 at 1x2."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree
    from repro_torch.core import (L2_BYP, LinkageConfig,
                                  build_sharded_train_step, make_train_step)
    from repro_torch.data import stage
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions, loss_fn
    from repro_torch.optim import adamw
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import shard, shard_leaf, spec_leaves
    kernel = ModelOptions(attn_impl="kernel", scan_impl="ref",
                          dtype=torch.float32, fused_norm=True)
    lk = LinkageConfig(level=L2_BYP, shortcut=True)
    cfg, ocfg, state, pipe = _train_state(MT_LAYERS, TRAIN_STEPS)
    fn, sspecs, bspecs = build_sharded_train_step(cfg, kernel, ocfg, lk,
                                                  mesh, state, TRAIN_BATCH)
    pieces = shard(state, sspecs, mesh)
    raw = [pipe.batch_at(i) for i in range(MT_STEPS)]
    out = {"mesh": mesh.describe(), "rank": mesh.rank,
           "backend": mesh.backend, "device": str(mesh.device)}

    # the unsharded kernel path, on this rank
    live = [p.detach().requires_grad_(True)
            for p in tree.leaves(state.params)]
    loss, _ = loss_fn(tree.unflatten(state.params, live),
                      stage(raw[0], "cuda"), cfg, kernel)
    grads = torch.autograd.grad(loss, live)
    del live
    out["ref_loss"] = float(loss.detach())
    out["ref_grad_norm"] = math.sqrt(sum(float(g.double().square().sum())
                                         for g in grads))
    want = [shard_leaf(g, sp, mesh, mesh.coords)
            for g, sp in zip(grads, spec_leaves(sspecs.params))]
    del grads, loss
    step = make_train_step(cfg, kernel, ocfg, inplace=True)
    out["ref_losses"] = []
    for b in raw:
        state, m = step(state, stage(b, "cuda"))
        out["ref_losses"].append(float(m["loss"]))
    del state, step, m
    torch.cuda.empty_cache()

    # the sharded step from the same init
    batches = [stage(b, "cuda", bspecs, mesh) for b in raw]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comm.reset_traffic()
    out["losses"], out["step_s"] = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof = None
        if i == MT_STEPS - 1:     # the last step profiled: device busy
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        g, m = fn.grads(pieces.params, b)
        if i == 0:
            out["loss"] = float(m["loss"])
            out["grad_norm"] = float(adamw.global_norm(g, sspecs.params,
                                                       mesh))
            out["max_rel_grad_diff"] = max(
                float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for a, w in zip(tree.leaves(g), want))
            del want
        pieces, m = fn.apply(pieces, g, m)
        del g
        out["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t)
        if prof is not None:
            prof.__exit__(None, None, None)
            ev = _device_events(prof)
            out["busy_s"] = sum(us for _, us in ev.values()) / 1e6
            out["cuda_records"] = sum(n for n, _ in ev.values())
    out["launches"] = ops.launch_counts()
    out["traffic"] = comm.traffic()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del pieces, batches
    torch.cuda.empty_cache()
    mt = os.path.join(ckpt_dir, "mt3")
    if mesh.describe() == "2x1":
        out["mt3"] = _mt3_rank(mesh, mt)
    else:
        out["mt2"] = _mt2_rank(mesh, os.path.join(mt, "clean"))
    torch.cuda.empty_cache()
    return out


def mesh_train_phase():
    """Training over a (data, model) mesh: full-width tinyllama-1.1b,
    fp32, the ranks of both meshes on the one H100 at once over gloo (a
    correctness run: ranks sharing a card, and every collective through
    host memory, measure no tensor-parallel or data-parallel speed).

    MT1  at 2x1 (FSDP and data parallelism: 2 of the 4 sequences a rank)
         and 1x2 (Megatron tensor parallelism, HQ 16, HKV 2 a rank, and
         FSDP's one-piece case), ``build_sharded_train_step`` at L2 with
         the flash and rmsnorm kernels against the unsharded kernel path
         from the same seed and batches, MT_LAYERS layers: step 1's loss,
         the whole gradient's norm (``adamw.global_norm`` over the
         pieces), every piece's max |dgrad| over its max |grad| (TR2_TOL),
         then MT_STEPS steps' losses within 10 x lr. Every rank launches
         flash forward and backward MT_LAYERS times a step and rmsnorm
         2 MT_LAYERS + 1.
    MT3  the launcher's rank entry (``launch/train.py: train_rank``, what
         ``--data-mesh 2`` runs in each rank) in the 2x1 ranks at
         MT3_LAYERS layers, ret_byp_shortcut read every call, MT3_STEPS
         steps, a checkpoint at step MT3_CKPT, clean and with a failure at
         step MT3_FAIL on every rank: one restart, the losses replayed
         bit for bit and each rank's final state's sha256 equal to the
         clean run's.
    MT2  the clean MT3 run's step-MT3_CKPT checkpoint (the 2x1 state,
         gathered, rank 0 writing) restored onto 1x2 (the gathered pieces
         equal to the file bit for bit) and onto one device here (equal
         to the file bit for bit); 1x2 trains on from it to step
         MT3_STEPS: its losses finite, below the last loss before the
         save, and within 10 x lr of the uninterrupted 2x1 run's.

    Logged: each rank's seconds a step (the last step profiled: device
    busy and idle share), peak memory and the bytes it handed each kind
    of collective a step. Returns the launch counts by (mesh, rank)."""
    import shutil
    import tempfile
    import threading

    from repro_torch import checkpoint as ckpt
    from repro_torch.launch.mesh import spawn
    _release()
    t_start = time.time()
    tol = TR2_TOL
    failed, counts, ranks, errors = [], {}, {}, []
    d = tempfile.mkdtemp(prefix="repro_torch_mt_")

    def run(spec):
        t0 = time.time()
        try:
            ranks[spec] = spawn(_mesh_train_rank, spec, "cuda", (d,),
                                deadline_s=420)
        except Exception as e:      # re-raised below
            errors.append(e)
        log(f"MT {spec.replace(',', 'x')}: spawn {time.time() - t0:.1f} s")
    try:
        # both meshes at once: 1x2 restores 2x1's checkpoint once committed
        threads = [threading.Thread(target=run, args=(spec,))
                   for spec in ("2,1", "1,2")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        # MT2 on one device, here
        mt2_dir = f"{d}/mt3/clean"
        _, _, like, _ = _train_state(MT3_LAYERS, MT3_STEPS)
        one = ckpt.restore(mt2_dir, MT3_CKPT, like)
        one_equal = _file_equal(mt2_dir, MT3_CKPT, one)
        one_step = int(one.step)
        del like, one
        _release()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for spec, rs in ranks.items():
        mname = spec.replace(",", "x")
        log(f"MT1 {mname}: backend {rs[0]['backend']}, devices "
            f"{[r['device'] for r in rs]}")
        for r in rs:
            per = {k: v / MT_STEPS for k, v in sorted(r["launches"].items())}
            traffic = {k: v / MT_STEPS
                       for k, v in sorted(r["traffic"].items())}
            counts[f"{mname} rank {r['rank']}"] = r["launches"]
            diffs = [abs(a - b) for a, b in zip(r["losses"], r["ref_losses"])]
            log(f"MT1 {mname} rank {r['rank']}: step 1 loss {r['loss']!r} "
                f"(unsharded {r['ref_loss']!r}), grad norm "
                f"{r['grad_norm']!r} (unsharded {r['ref_grad_norm']!r}), "
                f"max |dgrad| / max |grad| {r['max_rel_grad_diff']!r}; "
                f"losses {r['losses']} (unsharded {r['ref_losses']}, |d| "
                f"{diffs}); s a step {r['step_s']} (the last profiled: "
                f"device busy {r['busy_s']!r} s, {r['cuda_records']} CUDA "
                f"records; idle share against step 2's unprofiled wall "
                f"{max(0.0, 1 - r['busy_s'] / r['step_s'][1])!r}); peak "
                f"memory "
                f"{r['peak_memory_bytes'] / 1e9:.3f} GB; launches a step "
                f"{per}; bytes a step to the collectives {traffic}")
            if (abs(r["loss"] - r["ref_loss"]) > tol["loss"]
                    or abs(r["grad_norm"] - r["ref_grad_norm"])
                    > tol["grad_norm"] * r["ref_grad_norm"]
                    or r["max_rel_grad_diff"] > tol["grad"]
                    or max(diffs) > tol["losses"]
                    or not all(map(math.isfinite, r["losses"]))):
                failed.append(f"MT1 {mname} rank {r['rank']}: outside "
                              f"{tol}")
            for k, n in MT_LAUNCHES.items():
                if r["launches"].get(k, 0) != n * MT_STEPS:
                    failed.append(f"MT1 {mname} rank {r['rank']}: {k} "
                                  f"launched {r['launches'].get(k)} times "
                                  f"over {MT_STEPS} steps, want {n} a step")
    for r in ranks["2,1"]:
        clean, fail = r["mt3"]["clean"], r["mt3"]["failed"]
        want = clean["losses"][:MT3_FAIL] + clean["losses"][
            MT3_FAIL // MT3_CKPT * MT3_CKPT:]
        log(f"MT3 rank {r['rank']}: clean {clean['seconds']:.1f} s, losses "
            f"{clean['losses']}, sha256 {clean['state_sha256']}; failed "
            f"{fail['seconds']:.1f} s, restarts {fail['restarts']}, losses "
            f"{fail['losses']}, sha256 {fail['state_sha256']}; peak memory "
            f"{clean['peak_mem_gb']!r} / {fail['peak_mem_gb']!r} GB; "
            f"launches {clean['launches']}; bytes to the collectives "
            f"{clean['traffic']}")
        counts[f"MT3 rank {r['rank']}"] = clean["launches"]
        if (fail["restarts"] != 1 or fail["losses"] != want
                or fail["state_sha256"] != clean["state_sha256"]):
            failed.append(f"MT3 rank {r['rank']}: restarts "
                          f"{fail['restarts']}, losses {fail['losses']} "
                          f"against {want}, sha256 differ")
    clean = ranks["2,1"][0]["mt3"]["clean"]["losses"]
    after, before = clean[MT3_CKPT:], clean[MT3_CKPT - 1]
    mt2 = {"restored_equal": ranks["1,2"][0]["mt2"]["restored_equal"],
           "one_device_equal": one_equal, "one_device_step": one_step,
           "resumed_losses": [r["mt2"]["resumed_losses"]
                              for r in ranks["1,2"]],
           "2x1_losses_after": after, "last_before_save": before}
    log(f"MT2: {mt2}")
    for r in ranks["1,2"]:
        rl = r["mt2"]["resumed_losses"]
        if (not mt2["restored_equal"] or not one_equal
                or one_step != MT3_CKPT
                or r["mt2"]["resumed_step"] != MT3_STEPS
                or not all(map(math.isfinite, rl)) or max(rl) >= before
                or max(abs(a - b) for a, b in zip(rl, after))
                > tol["losses"]):
            failed.append(f"MT2 rank {r['rank']}: {mt2}")
    log(f"mesh train phase: {time.time() - t_start:.1f} s (ranks sharing "
        "one card over gloo measure correctness, not parallel speed)")
    if failed:
        raise AssertionError("; ".join(failed))
    return counts


def launch_log():
    """The instantiations of the kernels with dynamic shared memory beside
    ptxas's lines: for paged prefill each (query type, pool type, padded
    head dim), for flash each (type, padded head dim), for the split decode
    kernel each fp32 (query heads a block) and bf16 (padded head dim)
    instantiation over slot rows and over each pool type; the shared
    memory of each and how many of its blocks fit on one SM. Then the
    geometry that ``rmsnorm`` and ``moe_route`` choose at the paths' and
    the sweep's shapes, with the router's shared memory and the blocks of
    each that fit on one SM; and the geometry that ``rwkv_scan`` and
    ``mamba_scan`` choose at the paths', the sweeps' and the large shapes,
    with their shared memory and blocks per SM."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_ssm as kmamba
    from repro_torch.kernels import moe_route as kroute
    from repro_torch.kernels import paged_decode as kpd
    from repro_torch.kernels import paged_prefill as kpp
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import rwkv6 as krwkv
    from repro_torch.kernels import slot_decode as ksd
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128, 256):
            info = kfa.launch_info(dtype, dh)
            log(f"  flash_attention launch: {dtype} dh<={dh}: "
                f"{info['smem_bytes']} bytes of shared memory, "
                f"{info['blocks_per_sm']} blocks/SM")
        # the fp32 kernel by the query heads a block takes, the bf16
        # (tensor-core) one by the padded head dim
        for G, dh in (((1, 64), (2, 64), (4, 64), (8, 64))
                      if dtype == torch.float32 else
                      ((8, 64), (8, 128), (8, 256))):
            info = ksd.launch_info(dtype, G, dh)
            log(f"  slot_decode launch: {dtype} G={G} dh<={dh}: "
                f"{info['smem_bytes']} bytes of shared memory, "
                f"{info['blocks_per_sm']} blocks/SM")
            for kvd in (None, torch.int8, torch.float8_e4m3fn):
                info = kpd.launch_info(dtype, kvd, G, dh)
                log(f"  paged_decode launch: q {dtype} pool {kvd or dtype} "
                    f"G={G} dh<={dh}: {info['smem_bytes']} bytes of shared "
                    f"memory, {info['blocks_per_sm']} blocks/SM")
    for dtype in (torch.float32, torch.bfloat16):
        for dh in kfa.BWD_HEAD_DIMS:
            info = kfa.bwd_launch_info(dtype, dh)
            log(f"  flash_attention_bwd launch: {dtype} dh<={dh}: dq / dkdv "
                f"kernels {info['smem_bytes']} bytes of shared memory, "
                f"{info['blocks_per_sm']} blocks/SM, dkdv steps of "
                f"{kfa.bwd_query_step(dtype, dh)} queries")
    for dtype in (torch.float32, torch.bfloat16):
        for kvd in (None, torch.int8, torch.float8_e4m3fn):
            for dh in (64, 128, 256):
                info = kpp.launch_info(dtype, kvd, dh)
                log(f"  paged_prefill launch: q {dtype} pool "
                    f"{kvd or dtype} dh<={dh}: {info['smem_bytes']} bytes "
                    f"of shared memory, {info['blocks_per_sm']} blocks/SM")
    for dtype in (torch.float32, torch.bfloat16):
        for sdt in sorted({torch.float32, dtype}, key=str):
            for D, rows in ((2048, 4), (2048, 4096), (4096, 4), (7168, 4),
                            (12288, 4), (33, 35), (70001, 2)):
                info = krms.launch_info(dtype, sdt, D, rows)
                g = info["geometry"]
                log(f"  rmsnorm launch: x {dtype} scale {sdt} D={D} "
                    f"rows={rows}: {g.warps} warps a row, {g.rows} rows a "
                    f"block, {g.nv} packs of {g.vec} a lane, grid {g.grid}: "
                    f"{info['blocks_per_sm']} blocks/SM")
        for N, D, E in ((4, 2048, 64), (32, 2048, 64), (4, 4096, 16),
                        (4, 7168, 384), (32, 7168, 384), (5, 100, 512),
                        (2, 32, 2048), (4096, 2048, 64), (70, 99, 100),
                        (300, 256, 384)):
            info = kroute.launch_info(dtype, N, D, E)
            g = info["geometry"]
            log(f"  moe_route launch: {dtype} N={N} D={D} E={E}: {g.mode}, "
                f"{g.tiles} tiles of {g.tn}, {g.slices} slices of {g.cw} "
                f"experts, {g.splits} splits of {g.rows} rows: "
                f"{info['smem_bytes']} bytes of shared memory, "
                f"{info['blocks_per_sm']} blocks/SM")
        for B, S, nh, hd in ((1, PROMPT, 64, 64), (4, 1024, 64, 64),
                             (2, 31, 3, 32), (1, 5, 2, 100), (2, 9, 3, 33),
                             (1, 9, 2, 128), (1, 9, 2, 192), (2, 5, 2, 256),
                             (1, 3, 1, 512)):
            info = krwkv.launch_info(dtype, B, S, nh, hd)
            g = info["geometry"]
            log(f"  rwkv_scan launch: {dtype} (B,S,nh,hd)=({B},{S},{nh},"
                f"{hd}): {g.ti} key rows x {g.tj} columns a lane, "
                f"{g.slices} blocks a head, grid {B * nh * g.slices}, runs "
                f"of {g.tc} tokens: {info['smem_bytes']} bytes of shared "
                f"memory, {info['blocks_per_sm']} blocks/SM")
        for B, S, di, ds in ((1, PROMPT, 8192, 16), (4, 1024, 8192, 16),
                             (2, 17, 70, 5), (1, 9, 40, 32), (2, 9, 72, 64),
                             (1, 9, 48, 128), (2, 5, 20, 256)):
            info = kmamba.launch_info(dtype, S, ds)
            g = info["geometry"]
            log(f"  mamba_scan launch: {dtype} (B,S,di,ds)=({B},{S},{di},"
                f"{ds}): {g.ns} states a lane, {g.lanes} lanes a channel, "
                f"{g.channels} channels a block, grid "
                f"{-(-di // g.channels)}x{B}, runs "
                f"of {g.tc} tokens: {info['smem_bytes']} bytes of shared "
                f"memory, {info['blocks_per_sm']} blocks/SM")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on a GPU", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    resolve_device("cuda")
    smi = nvidia_smi()
    log("gpu:", smi)
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)
    t0 = time.time()
    lib = _build.build()
    log(f"build: {time.time() - t0:.2f} s -> {lib.relative_to(ROOT)}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill")):
            log("  ptxas:", line.split("info    :")[-1].strip()[:160])

    gen = torch.Generator(device="cuda").manual_seed(0)

    def phase(fn, *args):
        """Run one phase; log when it ended, in seconds since the start."""
        out = fn(*args)
        log(f"phase {fn.__name__} done at {time.time() - t0:.1f} s")
        return out

    if sys.argv[1:2] == ["compare"]:
        # each kernel named (all when none is) through its cases and its
        # path with the profile, without the teacher-forced checks or the
        # launch log: the mode also runs over an older tree's src/ with
        # this script copied in, to compare two trees in one call, and
        # skips the cases that tree refuses
        groups = {
            "rmsnorm": ((kernel_phase, gen, "", ("rmsnorm",)),),
            "moe_route": ((route_phase, gen,
                           ("main", "jamba", "large", "ties")),
                          (moe_phases, False)),
            "rwkv_scan": ((rwkv_scan_phase, gen, True),
                          (rwkv_phases, False)),
            "mamba_scan": ((mamba_scan_phase, gen, True),
                           (mamba_phases, False)),
            "flash_attention": ((kernel_phase, gen, "",
                                 ("flash_attention",)),),
            "flash_attention_bwd": ((flash_bwd_phase, gen),)}
        names = sys.argv[2:] or list(groups)
        if not set(names) <= set(groups):
            print(f"chip_smoke compare: kernels {sorted(groups)}, got "
                  f"{names}", file=sys.stderr)
            return 2
        for name in names:
            for fn, *args in groups[name]:
                phase(fn, *args)
        return 0
    launch_log()
    if sys.argv[1:2] == ["route"]:
        phase(route_phase, gen, tuple(sys.argv[2:]) or "")
        return 0
    if sys.argv[1:] == ["norm"]:
        phase(kernel_phase, gen, "", ("rmsnorm",))
        return 0
    if sys.argv[1:] == ["prefill"]:
        phase(kernel_phase, gen, "", PAGED_KERNELS)
        phase(teacher_forced_phase)
        return 0
    if sys.argv[1:] == ["attention"]:
        phase(kernel_phase, gen, "", ATTENTION_KERNELS)
        phase(teacher_forced_phase)
        return 0
    if sys.argv[1:] == ["moe"]:
        phase(moe_phases, False)
        return 0
    if sys.argv[1:] == ["scan-tiles"]:
        phase(scan_tiles_phase, gen)
        return 0
    if sys.argv[1:] == ["rwkv"]:
        phase(rwkv_scan_phase, gen)
        phase(rwkv_phases)
        return 0
    if sys.argv[1:] == ["modes"]:
        phase(kernel_phase, gen, "verify")
        phase(prng_phase)
        phase(modes_phase)
        phase(verify_teacher_forced_phase)
        phase(modes_profile_phase)
        return 0
    if sys.argv[1:] == ["tier"]:
        phase(tier_phase)
        phase(tier_transfer_phase)
        phase(tier_profile_phase)
        return 0
    if sys.argv[1:] == ["fleet"]:
        phase(fleet_phase)
        return 0
    if sys.argv[1:] == ["zoo"]:
        phase(kernel_phase, gen, "zoo")
        phase(route_phase, gen, "mixtral")
        phase(zoo_phase)
        return 0
    if sys.argv[1:] == ["train"]:
        phase(train_phases, gen)
        return 0
    if sys.argv[1:] == ["mesh"]:
        phase(kernel_phase, gen, "mesh")
        phase(mesh_phase)
        return 0
    if sys.argv[1:] == ["mesh-zoo"]:
        phase(mesh_zoo_phase, gen)
        return 0
    if sys.argv[1:] == ["mesh-train"]:
        phase(kernel_phase, gen, "mesh train")
        phase(mesh_train_phase)
        return 0
    if sys.argv[1:] == ["bwd"]:
        phase(flash_bwd_phase, gen)
        return 0
    if sys.argv[1:] == ["bwd-chunks"]:
        phase(bwd_chunk_phase, gen)
        return 0
    if sys.argv[1:] == ["mamba"]:
        phase(kernel_phase, gen, "jamba")
        phase(route_phase, gen, "jamba")
        phase(mamba_scan_phase, gen)
        phase(mamba_phases)
        return 0
    records = phase(kernel_phase, gen)
    bwd_rows = phase(flash_bwd_phase, gen)
    phase(quant_insert_phase)
    rep, _, counts, paged, slot_streams = phase(path_phase)
    phase(teacher_forced_phase)
    phase(profile_phase)
    phase(prng_phase)
    mode_counts = phase(modes_phase)
    phase(verify_teacher_forced_phase)
    phase(modes_profile_phase)
    tier_counts = phase(tier_phase)
    phase(tier_transfer_phase)
    phase(tier_profile_phase)
    fleet_counts = phase(fleet_phase, {n: paged[n][2] for n in "AC"})
    mesh_counts = phase(mesh_phase, {
        "slotted": (rep, slot_streams),
        **{n: (paged[n][0], paged[n][2]) for n in "AC"}})
    mesh_zoo_counts, mesh_zoo_rows = phase(mesh_zoo_phase, gen)
    route_rows = phase(route_phase, gen)
    rwkv_rows = phase(rwkv_scan_phase, gen)
    mamba_rows = phase(mamba_scan_phase, gen)
    moe_counts = phase(moe_phases)
    rwkv_counts = phase(rwkv_phases)
    mamba_counts = phase(mamba_phases)
    zoo_counts = phase(zoo_phase)
    _, train_counts, _ = phase(train_phases, gen, bwd_rows)
    mesh_train_counts = phase(mesh_train_phase)
    records["moe_route"] = route_rows
    records["flash_attention_bwd"] = bwd_rows
    records["rwkv_scan"] = rwkv_rows
    records["mamba_scan"] = mamba_rows

    # launches: each kernel's count in the run of the path that carries it
    # (the slotted --load open run; paged path A for paged_decode, paged
    # path B for paged_prefill), and every path's count beside it
    by_path = {"slotted open": counts,
               **{f"paged {n}": paged[n][1] for n in "ABCD"},
               "moe slotted open": moe_counts,
               "rwkv slotted open": rwkv_counts,
               "mamba slotted open": mamba_counts,
               **{f"modes {n}": c for n, c in mode_counts.items()},
               **{f"tier {n}": c for n, c in tier_counts.items()},
               **{f"fleet {n}": c for n, c in fleet_counts.items()},
               **{f"zoo {n}": c for n, c in zoo_counts.items()},
               **{f"mesh {n}": c for n, c in mesh_counts.items()},
               **{f"mesh zoo {n}": c for n, c in mesh_zoo_counts.items()},
               "train TR1": train_counts,
               **{f"mesh train {n}": c
                  for n, c in mesh_train_counts.items()}}
    home = {"rmsnorm": "slotted open", "flash_attention": "slotted open",
            "slot_decode": "slotted open", "paged_decode": "paged A",
            "paged_prefill": "paged B", "paged_decode_quant": "paged C",
            "paged_prefill_quant": "paged D", "moe_route": "moe slotted open",
            "rwkv_scan": "rwkv slotted open",
            "mamba_scan": "mamba slotted open",
            "flash_attention_bwd": "train TR1"}
    sources = {"rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm.py:36"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:164"),
               "slot_decode": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/slot_decode.py:52"),
               "paged_decode": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/paged_decode.py:135"),
               "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                                 "src/repro/kernels/paged_prefill.py:185"),
               "paged_decode_quant": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/paged_decode.py:37"),
               "paged_prefill_quant": (
                   "src/repro_torch/csrc/paged_prefill.cu",
                   "src/repro/kernels/paged_prefill.py:82"),
               "moe_route": ("src/repro_torch/csrc/moe_route.cu",
                             "src/repro/kernels/moe_route.py:47"),
               "rwkv_scan": ("src/repro_torch/csrc/rwkv_scan.cu",
                             "src/repro/kernels/rwkv6.py:75"),
               "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                              "src/repro/kernels/mamba_ssm.py:74"),
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:110")}
    out = []
    for name, (src, replaces) in sources.items():
        # the record's dtype is its home path's: float32, bf16 for the MoE
        home_dtype = ("torch.bfloat16" if name == "moe_route"
                      else "torch.float32")
        rows = [r for r in records[name] if r["dtype"] == home_dtype]
        main_row = rows[0]
        large = next((r for r in rows if r["label"].startswith("large")),
                     None)
        extra = large and {k: v for k, v in large.items() if k != "dtype"}
        seq = [r for r in rows if r["label"].startswith("main seq")]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": by_path[home[name]].get(name, 0),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
            "plain_device_ms": main_row.get("plain_device_ms"),
            "library_device_ms": main_row["library_device_ms"],
            "shape": main_row["label"],
            "large": extra,
        })
        if "library_gather_ms" in main_row:
            out[-1]["library_gather_ms"] = main_row["library_gather_ms"]
        verify = [r for r in rows if r["label"].startswith("verify")]
        if verify:    # at the verify pass's shape (paths S2, S3)
            out[-1]["verify"] = {k: v for k, v in verify[0].items()
                                 if k != "dtype"}
        if seq:       # slot_decode through the uniform wrapper (--load seq)
            out[-1]["seq"] = {k: v for k, v in seq[0].items()
                              if k != "dtype"}
        fp8 = [r for r in rows if r["label"].startswith("main")
               and r["label"].endswith("fp8")]
        if fp8:       # the quantized kernels: the record is int8, then fp8
            out[-1]["fp8"] = {k: v for k, v in fp8[0].items()
                              if k != "dtype"}
        moe = [r for r in records[name] if r["label"].startswith("moe")
               and r["dtype"] == "torch.bfloat16"]
        if moe:       # at the MoE path's shapes, in its dtype (bf16)
            out[-1]["moe"] = {k: v for k, v in moe[0].items()
                              if k != "dtype"}
        zoo = [r for r in records[name]
               if r["label"].startswith(("zoo", "mixtral"))]
        if zoo:       # at the zoo's head shapes (Z1-Z7), both dtypes
            out[-1]["zoo"] = zoo
        jamba = [r for r in records[name] if r["label"].startswith("jamba")
                 and r["dtype"] == "torch.float32"]
        if jamba:     # at the Mamba path's shapes, in its dtype (fp32)
            out[-1]["jamba"] = [{k: v for k, v in r.items() if k != "dtype"}
                                for r in jamba]
        if name in mesh_zoo_rows:   # at a 1x2 rank's local shapes
            out[-1]["mesh_zoo"] = mesh_zoo_rows[name]
        if name in ("rwkv_scan", "mamba_scan"):
            out[-1].update({k: main_row[k] for k in (
                "device_mean_ms", "cold_device_ms", "cold_device_mean_ms")})
            out[-1]["bfloat16"] = [{k: v for k, v in r.items()
                                    if k != "dtype"}
                                   for r in records[name]
                                   if r["dtype"] == "torch.bfloat16"
                                   and "ms" in r]
        if name == "rwkv_scan":
            out[-1]["library_calls"] = ("none: no PyTorch call computes the "
                                        "RWKV-6 recurrence")
        if name == "mamba_scan":
            out[-1]["library_calls"] = ("none: no PyTorch call computes the "
                                        "selective scan")
        if name == "flash_attention_bwd":
            out[-1]["launches_per_train_step"] = (
                train_counts.get(name, 0) / TRAIN_STEPS)
            out[-1]["library_calls"] = ("SDPA forward + backward through "
                                        "autograd (the port runs neither)")
            out[-1]["cases"] = [r for r in records[name] if r is not main_row]
        if name == "moe_route":
            out[-1]["library_calls"] = ("torch.topk(torch.softmax(x.float() "
                                        "@ router.float(), -1), k): 3 calls")
            out[-1]["float32"] = {k: v for k, v in records[name][0].items()
                                  if k != "dtype"}
    print(json.dumps({"kernels": out}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
