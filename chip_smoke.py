"""GPU smoke run of the PyTorch/CUDA port (`fastforward_tpu_torch`).

    python3 chip_smoke.py [--out DIR]

Needs one NVIDIA GPU (built for the H100, sm_90a) and nvcc. Eleven phases,
each raising on failure:

1. build  — compile every CUDA kernel of the port from `csrc/` (one nvcc
   per source, in parallel) and print the build time;
2. kernels — run each kernel and its plain PyTorch version on the card at
   the Llama-3-8B shapes of the serving and engine phases and hold them
   together (GEMVs, the unpaired two-level one too, the W8A8 GEMM, argmax
   ids, the dequants and the KV appends, stacked, per-layer and paged,
   bit-equal; the W8A8 GEMM and the float-scale W4A8 GEMV on int8 wgmma
   (IGMMA and no IMMA in their libraries' SASS), bit-equal also at M = 1,
   8, 17 and 256 on the four projections and the f32 lm_head, the GEMM at
   the prefill's M = 24,576, their library the faster of torch._int_mm on
   the weight as it lies and on a K-major copy; the W4 GEMV (wgmma, HGMMA
   in its SASS; also at M = 8) within W4_GEMV_RTOL; flash decode (stacked,
   per-layer, paged) and flash prefill (int8 and bf16 K/V) within rtol
   8e-3 of the largest output;
   every route of the stacked W4A8 GEMV (flat, pre-blocked, the manual
   stream at 2 and 4 stages, split-W, dot-raw and concat-pairs at 4 pairs
   a unit on either layout, concat-pairs at 3, which divides no
   projection's pair count) and the pre-blocked dequant bit-equal, at M =
   192 and 8 with the ring depth of each shape logged;
   the int8 tensor-core tile's entries (the W4A8 GEMV paired and unpaired,
   the stacked GEMV's six routes, the A4 GEMV, the argmax head) bit-equal
   at M = 1, 8, 17, 192 and 256 on the lm_head (g512 and g128, f32 and
   bf16; the argmax head with tied columns, a zero row and a NaN row), the
   seven unfused projections of a layer and the four fused ones through
   every stacked route on either layout, and the A4 GEMV on the four fused
   projections at g512 and a g128 and a g32 shape;
   the float-scale W4A8 GEMV bit-equal and the W4 GEMV within
   W4_GEMV_RTOL at g256 and g512 (groups over several 128-k stages) on the
   four projections and the f32 lm_head, M = 192; flash prefill over a
   bf16 cache also at the ragged chunk (B 16, T 77, starts 0..300);
   the tiled W4A16 kernel (off the serving route; wgmma, HGMMA in its
   SASS) at bench.py's w4a16 prefill (M = 24,576, the four projections)
   within W4_GEMV_RTOL and one bf16 ulp, its bias epilogue exact; every
   route of the int4/int8 dot probe (dp4a, int8, int4 and bf16 mma.sync)
   bit-equal, its TOP/s and the tensor-core instructions ptxas chose for
   each route logged;
   the fused layer tail and the fused o + gate/up head (their products
   the int8 tensor-core tile: IMMA and no IDP4A in the SASS of the tail's
   library) with x1 bit-equal, their int8 activations within one level in
   a stated share of elements and their output within rtol 8e-3, each
   call's device time logged by kernel beside the unfused route's on the
   same tile; the fused layer heads (W4A8, A4;
   both products the int8 tensor-core tile, IMMA in its SASS) with
   their activations within one level in that share and their output
   within rtol 8e-3, bit-equality logged);
   rows 16, 17 and 18t at the groups their tensor-core kernels read x for
   permuted into byte-row order (IGMMA in row 16's permuted kernel): the
   four projections and the f32 lm_head at g 16 (M = 1, 8, 17, 192, 256),
   down_proj at g 112 and at g 8 (1,792 groups: the window tree; M = 8,
   192), K = g = 192 and 320 (M = 8, 192, both outputs), g 2 (K = 64 and
   4,096), row 16 at K = g = 2^17 (int64 group dots), at g 2 beyond 32^4
   groups (the tree's fifth level) and at g = 2^16 + 2 with 257 and 1,025
   groups (int64 dots, every window and the tree): row 16 bit-equal, 17
   and 18t within W4_GEMV_RTOL, 18t's bias epilogue exact, one launch a
   call under the row's own count; down_proj at g 112 and g 128 and the
   four projections at g 16 timed (M = 192) beside their bounds and
   libraries; the decode step's fused K/V quantize and append in its
   three forms (stacked, per layer, paged) at B = 192, Hkv 8, D 128, v a
   strided view, starts -1 and S, a page id of -1: bit-equal to the
   quantizer and the plain append; the two-level GEMVs' any-group route
   (groups the tensor-core tile does not take, on the same tensor cores:
   rows 1 (f32 and bf16), 5 (both layouts), 4 and 9 at every group 1-14
   their layouts take, M = 1, 8, 17, 192, bit-equal; N % 4 != 0, panel
   widths 4 and 6, and 1,024 groups of 14 along K; timed on down_proj at g
   14, M = 192, beside the tile at g 16) and the fused heads, tail and
   o + gate/up head at g 2 and 4 (M = 8, held as on the tile, timed beside
   the tile at g 4 and 8);
   print median times, device times (from profiles that recorded every
   launch: `device_ms`), bounds and library times (the two-level GEMVs:
   torch.matmul of the dequantized operands, also at M = 8);
3. serve  — Llama-3-8B at full width and depth (32 layers), random weights
   from the port's own `random_stacked_params` (stacked runs) or
   `random_serving_params` (per-layer runs), a 512-token cache, greedy
   decoding. Twenty-eight runs, each with its launch counts set to 0 before
   it and asserted exactly after it:
   (a) bench.py's default: W4A4 at group 512 (lm_head W4A8), 192 prompts
       of 128 tokens, then 32 tokens each;
   (b) bench.py's FF_BENCH_MODE=w4a8_2l: W4A8 at group 128, same shape;
   (c) W4A4 g512, 8 prompts of 32 tokens: the prefill of at most 256
       rows, through the A4 GEMV;
   (e), (f), (g) bench.py's FF_BENCH_MODE=w4a8, w4a16 and w8a8, group 128,
       bench.py's shape, the lm_head in the layers' mode;
   (h) the per-layer path (`serving_forward` + `make_decode_loop` over a
       `KVCache`) in w4a8 g128 with an INT8 cache, bench.py's shape;
   (i) the per-layer path in w4a8_2l g128 (unpaired, as the JAX package's
       `random_serving_params` makes it) with the default bf16 cache;
   (k) (a) with FF_FUSED_QKV=1: the fused A4 layer head;
   (l) (b) with FF_FUSED_QKV=1 FF_FUSED_OGU=1: the fused W4A8 layer head
       and the fused o + gate/up head of the tail (192 rows: past the
       fused tail's 64), down_proj by the stacked GEMV;
   (m) (b) with FF_2L_PREBLOCK=1: weights pre-blocked into 512-column
       panels at fuse time, the pre-blocked dequant and GEMV;
   (n) (b) with FF_2L_PREBLOCK=1 FF_2L_MANUAL=4: the manual stream;
   (o) (b) with FF_2L_SPLITW=1: split-W on flat weights;
   (p) (b) with FF_2L_DOTRAW=1: the dot-raw GEMV;
   (q) (b) with FF_2L_CONCAT_PAIRS=4: the concat-pairs GEMV;
   (r) bench.py's baseline tier, sim_w4 g128: dense bf16 weights
       quantized and dequantized on every use, one torch.matmul a
       projection; attention through the port's kernels;
   (ac) FF_BENCH_MODE=w4a8 and w4a16 at FF_BENCH_GROUP=16, bench.py's
       shape, the lm_head in the layers' mode: every decode GEMV (129 a
       step) on the permuted route of rows 16 and 17, counted under
       w4a8_gemv_halves and w4_gemv, and compared at depth 2 as below;
   (ag) FF_BENCH_MODE=w4a4_2l and w4a8_2l at FF_BENCH_GROUP=14, bench.py's
       shape: down_proj (K = 14,336, 1,024 groups of 14) on the two-level
       GEMVs' any-group route at every layer and step (a4_gemv_any,
       w4a8_gemv_stacked_any), every other projection and the lm_head at
       g = K = 4,096 on the tile, and compared at depth 2 as below;
   (ad) (b)'s weights, right after (b) in the same process, under
       FF_KV_STACKED=0 (the slab flow: per-layer append and flash decode,
       kv_append_layer and flash_decode_layer 1,024 each in place of the
       stacked ones), FF_KV_WRITE=mask and =scatter (plain-torch writes,
       no append kernel, flash_decode_layer 1,024) and
       FF_PREFILL_STACKED=0 (the prefill written a sequence at a time; no
       count moves): (b)'s greedy tokens and prefill logits bit for bit;
       FF_KV_STACKED=0 also at depth 2 with every kernel call checked;
   (ae) the same weights under FF_BENCH_FLASH=0 (dense decode attention,
       no flash decode) and FF_FLASH_PREFILL=0 (dense prefill attention,
       no flash prefill): the share of (b)'s tokens kept logged; at depth 2,
       stacked and per layer (INT8 KVCache), each route's logits row by row
       within LOGIT_RMS["w4a8_2l"] of the flash routes' but for at most
       AE_ROW_SHARE of the rows;
   (af) (b)'s weights repacked into the group-halves layout
       (`repack_unpaired`) under FF_2L_PAIRED=0: every decode GEMV and the
       lm_head on the unpaired GEMV (w4a8_gemv_unpaired 4,129), (b)'s
       tokens and prefill logits; at depth 2 (weights packed under the
       flag) every kernel call checked. (b)'s weights are freed after (af).
   Every int8-cache decode step quantizes and appends its K/V in one
   launch a layer (counted under kv_append, kv_append_layer or
   paged_kv_append). (m)-(q) run on (b)'s seed and weights and must give (b)'s greedy
   tokens, and its prefill logits bit for bit where (b)'s were bit-equal
   to its warm-up's. The serving flags (FLAG_VARS) are unset for every
   other run and set only around (k)-(q)'s and (ad)-(af)'s.
   Each prints prefill ms, decode tok/s, peak memory and profiles of one
   decode step and one prefill. (h)'s weights also go through
   `stack_serving_layers` and the stacked forward, 8 prompts of 128 tokens
   and 32 steps, which must give the per-layer path's greedy tokens. Then,
   at depth 2 for every run but (c), the kernel path is compared with the
   plain path on the card, 192 prompts of 128 tokens, under the run's flags;
   8 prompts with FF_FUSED_LAYER=0 FF_FUSED_OGU=1 (the o + gate/up head
   at 8 rows); 8 prompts with FF_2L_PREBLOCK=1 (the pre-blocked GEMV,
   not the fused tail); w4a8 and w4a16 at g256 (their decode GEMVs
   with groups of two 128-k stages) and at g 16 (run (ac)'s), 192 prompts;
4. engine — bench.py's continuous-batching workload (measure_engine with
   FF_BENCH_MODE=w4a8_2l FF_BENCH_ENGINE_PAGED=1 FF_BENCH_ENGINE_SAT=1,
   one pass): Llama-3-8B w4a8_2l g128 at full depth, 32 slots on the paged
   INT8 pool (39 pages of 256 tokens), 64 requests of 16-96 prompt tokens
   and 32 new tokens each, bursts of 8. Launch counts asserted exactly
   from the engine's own counters; the same trace through a slab engine
   gives the same tokens, request by request; the trace through a slab
   engine with a bf16 cache (quantized_cache=False) gives in-vocabulary
   tokens and launches no append or flash-decode kernel; at depth 2 the
   paged decode
   at 32 rows (paged append, paged flash decode, fused layer tail) is
   compared with the plain path;
5. loader — (j): a Llama-3-8B-wide, 2-layer bf16 checkpoint in HF layout
   (~3 GB, written by the port's own safetensors writer to a temporary
   directory) loaded by `load_llama` on the card in w8a8 and w4a8 (load
   time and GB/s printed); the card's quantized q_proj and lm_head equal
   the plain quantizer's on the CPU byte for byte; the loaded model serves
   8 prompts of 32 tokens and 8 greedy steps over an INT8 cache;
6. moe — (s): one MoE block at Mixtral-8x7B's expert widths (hidden 4096,
   intermediate 14336, 8 experts, top 2; w4a8_2l g128, 0.7 GB packed) at
   192 and 8 tokens: launches exact (16 of row 5), every kernel call held
   against its plain version, wall and device ms, device ms by kernel;
7. parallel — two processes on the one card over gloo (NCCL takes one
   rank a device): (t) Llama-3-8B w4a8_2l g128 at tp 2, a 192 x 128
   prefill through the TP stacked forward and 32 greedy steps through
   `make_tp_decode_loop`, launches exact on both ranks, identical tokens,
   a step's wall and device time (`make_tp_decode_step`), and at depth 2
   every kernel call checked and the logits within TP_LOGIT_RMS of the
   one-card path; (u) (s)'s block at EP 2 (`expert_parallel_moe`), its
   output within one bf16 ulp of the largest of (s)'s; (v) ring attention
   (`context_parallel_attention`) at SP 2 on Llama-3-8B's attention widths
   (B 1, H 32, D 128, T 4,096, bf16, causal), both ranks' full outputs
   bit-equal and within one bf16 ulp of the largest output of a
   one-process dense attention, a K/V hop and the output's gather timed;
   (w) a GPipe pipeline (`pipeline_forward`) at PP 2 of 32 w4a8_2l g128
   layers at o_proj's 4,096 x 4,096, x (192, 4,096) f32 in 4 microbatches:
   64 row-5 launches a rank, every kernel call held against its plain
   version, bit-equal to the rank's sequential loop; `dryrun_multichip` on
   both ranks (its line printed);
8. quant — (x) the simulation tier's core: `quantize_by_tile` and
   `dequantize_by_tile` and their LSQ backward on gate_proj's 4,096 x
   14,336 f32 per channel (8-bit) and per (128, 1) block (4-bit), and
   `quantize_dynamic_by_tile` per row on (192, 4,096), bit-equal to the
   same functions on a CPU copy (scale and offset gradients within
   QUANT_GRAD_RTOL); then `LayerKVCache.append(quantizer=)` at (h)'s cache
   shape: one fused K/V quantize-append launch, bit-equal to the plain
   append of the quantizer's QDQ'd k/v, and one flash decode over it;
9. sim — (y) the FastForward workflow on one Llama-3-8B layer's seven
   projections (bf16 `torch.nn.Linear`s, no bias): `quantize_model`, an
   int8 symmetric per-output-channel `LinearQuantizer` on each weight
   (min-max range), then each projection at M = 192 and 8 through
   `ops.linear`, which the dispatcher sends to the W8A8 GEMM (row 19):
   exactly 7 launches a pass, each output bit-equal to
   `matmul_w8a8_reference` on the same `quantize_rowwise` operands, within
   SIM_RMS (relative RMS) of the dense fallback `F.linear(x,
   qt.dequantize())`; `F.linear(x, qt)` through `__torch_function__` one
   launch and the same bits; `qt * 2.0`, `-qt`, `torch.transpose` and a
   per-tensor `torch.reshape` equal to a CPU copy's; `qt + qt` refused
   under strict quantization, the dense sum without it; after
   `freeze_parameters` no launch and the dense fallback's bits. Wall and
   device ms a pass, split into the weight quantizers, the transposed
   weight copy, `quantize_rowwise` and row 19; the peak memory;
10. quickstart — (z) the quickstart's simulation-to-serving path
   (`docs/quickstart_llm.md:14-60`) on Llama-3-8B's widths at 2 layers
   (bf16 weights from a seeded generator): `quantize_model`, three
   `QuantizationConfig` rules (8-bit parameters per tensor; 4-bit
   symmetric Linear weights in g128 blocks along the in-features, one per
   output channel; 8-bit symmetric layer inputs per tensor), the quantizers
   counted per bits, granularity and tag; `estimate_ranges` (smoothed
   min-max) over 8 seeded 128-token sequences; GPTQ stage by stage
   (`layerwise_optimize_staged` over ``layers/*``), each projection's
   error on its captured inputs no larger than round-to-nearest's on the
   same grid; `freeze_llama` (w4a8 g128, static input scales), each frozen
   projection's grid, scales and bf16 weight bit-equal to the simulated
   ones; then the per-layer serve (192 x 128 prefill, 32 greedy steps, INT8
   cache) with every kernel call held against its plain version, launch
   counts exact (rows 15, 16, 7, 21, 20), the prefill logits within
   QUICKSTART_RMS (relative RMS) of the simulated model's on 16 prompts;
   seconds for the configuration, a calibration batch, GPTQ a layer (its
   Hessians, inversions and column loop), the freeze, prefill ms, decode
   step ms, tok/s and the peak; at most QUICKSTART_BUDGET_S seconds;
11. gpt2 — (aa) GPT-2-small (BASELINE config 2) at full width and depth,
   f32 weights from a seeded generator on the card: the float forward of 8
   x 1,024 seeded ids; `quantize_model` and config 2's rules in torch's
   layout (8-bit symmetric parameters, int8 symmetric per-output-channel
   Linear weights, 8-bit asymmetric activations), running min-max on 4
   seeded batches, then the weights' minimum-error grid; the quantized
   forward: exactly 48 `w8a8_gemm` launches (4 Linears x 12 blocks), each
   call bit-equal to `matmul_w8a8_reference` on the same operands, the
   logits' SQNR against the float forward after both calibrations at least
   GPT2_SQNR_DB on the first GPT2_SQNR_T positions and GPT2_SQNR_FLOOR over
   1,024; wall and device ms a forward split into row 19, the transposed
   weight copy, the weight quantizers and the rest; row 19 at GPT-2's four
   shapes (M = 8,192) timed against its bound and torch._int_mm; then
   `autoquantize` on a float copy and the fx plan (`trace_quantization_sites`
   under `scoped_forward`, `install_from_config`, `observe`, `quantized`) on
   another at one config, their logits within GPT2_BRIDGE_TOL; the module
   graph of the quantized model (`trace_modules`), its coarse execution and
   `run_scheduled` over its nodes bit-equal to the model; `export` of blocks
   0-1 to a `.pt2`, reloaded and run against the export-mode forward; at
   most GPT2_BUDGET_S seconds;
12. tier — (ab) BASELINE's tier-parity criterion and the checkpoint
   formats on (z)'s 2-layer Llama-3-8B (no GPTQ): `quantize_model`, 4-bit
   symmetric g128 blocks on every Linear weight with min-max ranges from
   the weights; over 4 seeded batches of 2 x 128 ids (256 rows, the modes'
   GEMVs) `perplexity_delta` of the simulated tier against `serving_forward`
   of `freeze_llama` w4a16 (row 17), then, after 8-bit per-tensor input
   quantizers calibrated by running min-max on the same batches, of w4a8
   with static input scales (row 16): each relative delta below
   TIER_REL_DELTA, the exec logits' SQNR against the simulated ones logged,
   launch counts exact, every kernel call held once against its plain
   version; `save_quantization_state` into a temporary directory and
   `load_quantization_state` into a fresh model of the same seed (every
   scale and offset bit-equal, both frozen in w4a8 byte-equal);
   `save_params` / `load_params` of the frozen params onto the card (bytes
   and logits equal, write and read GB/s); a traced exec forward
   (`profiling.trace_to`, `annotate`) whose trace names the annotation and
   a kernel of the port, `profiling.benchmark` of it and the peak from
   `device_memory_stats`; at most TIER_BUDGET_S seconds.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when CUDA is absent or the package cannot be imported. ``--out``
also writes the log there.
"""

import collections
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
FLASH_RTOL = 8e-3              # one bf16 ulp, relative to the largest output
# W4 GEMV (w4a16 decode) against its plain version: f32 outputs within this
# share of the largest output (tensor-core sums in another order; the
# error measured on an H100 is in PERF.md), bf16 outputs one bf16 ulp more.
W4_GEMV_RTOL = 1e-4
# Kernel path vs plain path at depth 2: relative RMS error of the logits
# (see compare_paths). Measured on an H100 at the prefill: 0.144 (w4a4_2l),
# 0.0099 (w4a8_2l), 0.058 (w8a8: its random int8 weights amplify each
# layer's input more), 0.0012 (w4a8), 0.0005 (w4a16); the limits leave
# room for other weights and inputs. sim_w4 (bf16 activations, as w4a16's)
# takes w4a16's limit.
LOGIT_RMS = {"w4a4_2l": 0.3, "w4a8_2l": 0.03, "w8a8": 0.15, "w4a8": 0.03, "w4a16": 0.03,
             "sim_w4": 0.03}

# The fused layer tail's int8 activations (hq, x2) may sit one level from
# the plain version's where the IEEE rsqrt and the row sums round unlike
# PyTorch's; at most this share of their elements may (the counts measured
# on an H100 are in PERF.md's kernel findings).
TAIL_LEVEL_SHARE = 1e-3

PROJ = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
        "down": (14336, 4096)}   # (K, N) of one fused Llama-3-8B layer
LAYER_PROJ = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024), "o": (4096, 4096),
              "gate": (4096, 14336), "up": (4096, 14336),
              "down": (14336, 4096)}  # (K, N) of one unfused Llama-3-8B layer
VOCAB = 128256                   # Llama-3-8B's lm_head width
BATCH, PROMPT, STEPS, SLAB = 192, 128, 32, 512   # bench.py's shape
FLAGS_K = {"FF_FUSED_QKV": "1"}                          # run (k): the A4 layer head
FLAGS_L = {"FF_FUSED_QKV": "1", "FF_FUSED_OGU": "1"}     # run (l): head and o + gate/up
FLAGS_M = {"FF_2L_PREBLOCK": "1"}                        # run (m): pre-blocked weights
FLAGS_N = {"FF_2L_PREBLOCK": "1", "FF_2L_MANUAL": "4"}   # run (n): the manual stream
FLAGS_O = {"FF_2L_SPLITW": "1"}                          # run (o): split-W
FLAGS_P = {"FF_2L_DOTRAW": "1"}                          # run (p): dot-raw
FLAGS_Q = {"FF_2L_CONCAT_PAIRS": "4"}                    # run (q): concat-pairs
# runs (ad): (b)'s weights through the slab flow's KV writes and attention;
# (ae): the dense attention routes; (af): (b)'s weights repacked unpaired
FLAGS_AD = ({"FF_KV_STACKED": "0"}, {"FF_KV_WRITE": "mask"}, {"FF_KV_WRITE": "scatter"},
            {"FF_PREFILL_STACKED": "0"})
FLAGS_AE = ({"FF_BENCH_FLASH": "0"}, {"FF_FLASH_PREFILL": "0"})
FLAGS_AF = {"FF_2L_PAIRED": "0"}
# (ae) at depth 2: the dense routes' logits against the flash routes', row by
# row. A row of the random model can land in another of its attractors when
# its attention rounds otherwise, and the two routes' plain f32 forms differ
# so in whole rows too (fastforward_tpu_torch/scripts/dense_rows.py; PERF.md
# §7). At most this share of the rows may lie beyond LOGIT_RMS["w4a8_2l"]
# (relative error of the row), every other row within it.
AE_ROW_SHARE = 0.02
PANEL = 512   # FF_2L_BLOCK_N's default: the pre-blocked panel width of (m), (n)
# bench.py's engine workload (measure_engine, FF_BENCH_ENGINE_PAGED=1,
# FF_BENCH_ENGINE_SAT=1) at max_batch 32: 2 x 32 requests, pool of
# int(32 * 2 * 0.6) + 1 pages of 256 tokens, bursts of 8
ENGINE_SLOTS, ENGINE_MAXLEN, ENGINE_PAGE, ENGINE_BURST = 32, 512, 256, 8
ENGINE_PAGES = int(ENGINE_SLOTS * 2 * 0.6) + 1
ENGINE_PROMPTS = (16, 32, 64, 96)

_LOG = {"file": None}

# The serving flags the port reads (fastforward_tpu_torch/flags.py).
FLAG_VARS = ("FF_FUSED_QKV", "FF_FUSED_OGU", "FF_FUSED_LAYER", "FF_FUSED_ARGMAX",
             "FF_2L_PREBLOCK", "FF_2L_BLOCK_N", "FF_2L_MANUAL", "FF_2L_SPLITW", "FF_2L_DOTRAW",
             "FF_2L_CONCAT_PAIRS", "FF_KV_WRITE", "FF_KV_STACKED", "FF_PREFILL_STACKED",
             "FF_BENCH_FLASH", "FF_FLASH_PREFILL", "FF_2L_PAIRED")
# The int4/int8 dot probe: chained calls a route's timing takes (P4_SCAN,
# cut from the probe's 2000 to keep its phase to seconds) and its passes
PROBE_SCAN, PROBE_PAIRS = 20, 2


def flag_env(**flags):
    """The process environment with the serving flags set to ``flags`` and
    the others unset, for the time of a ``with`` block."""
    env = {k: v for k, v in os.environ.items() if k not in FLAG_VARS}
    return mock.patch.dict(os.environ, {**env, **flags}, clear=True)


def log(*args):
    """Print a line, and append it to the log file of ``--out``."""
    line = " ".join(str(a) for a in args)
    print(line, flush=True)
    if _LOG["file"] is not None:
        _LOG["file"].write(line + "\n")
        _LOG["file"].flush()


def median_ms(fn, n=20):
    """Median time of ``fn`` over ``n`` calls (CUDA events around each
    call, synchronized: host launch included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile(fn, n, launches=None, tries=8):
    """(wall ms per call, [(device ms per call, launches per call, kernel
    name)] sorted by time) of ``n`` calls of ``fn`` under torch.profiler.
    With ``launches`` (the kernels one call launches) a profile that
    recorded fewer than ``n * launches`` of them (CUPTI drops records now
    and then) is refused and taken again, up to ``tries`` times; if every
    try lost records, each kernel's device time a call is its mean time a
    recorded launch times its launches a call (its recorded count over
    ``n``, rounded), provided those add up to ``launches`` (no kernel lost
    whole); else RuntimeError."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        recorded = sum(e.count for e in events)
        if launches is None or recorded >= n * launches:
            rows = [(e.self_device_time_total / n / 1e3, e.count / n, e.key) for e in events]
            return wall_ms, sorted(rows, reverse=True)
        log(f"  profiler recorded {recorded} of {n * launches} launches; profiling again")
        time.sleep(0.5)  # a lossy profile tends to be followed by another at once
    per_call = [max(1, round(e.count / n)) for e in events]
    if sum(per_call) != launches:
        raise ProfileLost(f"the profiler recorded fewer than {n * launches} launches in {tries} "
                           f"tries, and some kernel too seldom to time it")
    log("  every profile lost records: each kernel timed by its mean recorded launch")
    rows = [(e.self_device_time_total / e.count / 1e3 * k, k, e.key)
            for e, k in zip(events, per_call)]
    return wall_ms, sorted(rows, reverse=True)


def launches_per_call(fn, probes=6):
    """The kernels one call of ``fn`` launches: the most that profiles of a
    single call recorded, once two of them (of at most ``probes``) have
    recorded that many; 0 when none recorded a launch."""
    seen = []
    for _ in range(probes):
        seen.append(round(sum(r[1] for r in _profile(fn, 1)[1])))
        if max(seen) > 0 and seen.count(max(seen)) >= 2:
            break
    return max(seen)


class ProfileLost(RuntimeError):
    """The profiler lost records of every try at a profile."""


def device_ms(fn, n=20, launches=None, tries=8):
    """Kernel time on the card per call of ``fn`` (the sum of the device
    time of every kernel launched), from a profile of ``n`` calls that
    recorded all ``n * launches`` of their launches (``launches``: given,
    or `launches_per_call`; at most ``tries`` profiles); None ("not
    measured") when the profiler records none, or loses records of every
    try: a time is a measurement, not a check of the kernel, and none is
    made up."""
    fn()
    if launches is None:
        launches = launches_per_call(fn)
    if launches == 0:
        return None
    try:
        return sum(r[0] for r in _profile(fn, n, launches, tries)[1])
    except ProfileLost as e:
        log(f"  device time not measured: {e}")
        return None


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def max_err(a, b):
    """Largest absolute difference of two tensors (0.0 when bit-equal and finite)."""
    return (a.double() - b.double()).abs().max().item()


def bound(nbytes, ops, ops_per_s):
    """(bytes ms, operations ms): the least time for the bytes at the
    memory rate and for the operations at the peak rate of their type."""
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s


def measure(name, label, kern, plain, nbytes, ops, ops_per_s, check, library=None, plain_n=20):
    """Check ``kern`` against ``plain`` with ``check(out, ref) -> (ok, err)``,
    time both (the plain version over ``plain_n`` calls), log one line;
    returns the row."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    ok, err = check(out, ref)
    del out, ref
    if not ok:
        raise AssertionError(f"{name} {label}: kernel disagrees with its plain version (err {err})")
    ms, pms, dms = median_ms(kern), median_ms(plain, plain_n), device_ms(kern)
    bb, bo = bound(nbytes, ops, ops_per_s)
    lib = median_ms(library) if library is not None else None
    log(f"{name} {label}: {ms:.4f} ms, device {fmt_ms(dms)} (plain {pms:.3f} ms, bound "
        f"{max(bb, bo):.4f} ms{'' if lib is None else f', library {lib:.4f} ms'}), err {err:.3g}")
    return dict(ms=ms, device_ms=dms, plain_ms=pms, bytes_ms=bb, ops_ms=bo, max_abs_err=err,
                library_ms=lib)


def bit_equal(out, ref):
    return torch.equal(out, ref), max_err(out, ref)


def within_rtol(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err <= FLASH_RTOL * ref.float().abs().max().item(), err


# Largest error of the W4 GEMV's (and the tiled W4A16 kernel's) outputs
# relative to the largest plain output, per dtype, over every check of this
# run (w4_close).
W4_REL_ERR = collections.Counter()
W4A16_TILED_REL_ERR = collections.Counter()


def w4_close(out, ref, record=W4_REL_ERR):
    """The W4 GEMV and the tiled W4A16 kernel (tensor-core f32 sums in
    another order than the plain version's): each output within
    W4_GEMV_RTOL of the largest plain output, plus one bf16 ulp for bf16
    outputs; the largest relative error kept in ``record``."""
    o, r = out.float(), ref.float()
    top = r.abs().max()
    tol = W4_GEMV_RTOL * top
    if out.dtype == torch.bfloat16:
        mag = torch.maximum(o.abs(), r.abs()).clamp_min(torch.finfo(torch.float32).tiny)
        tol = tol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (o - r).abs()
    key = str(out.dtype).split(".")[-1]
    record[key] = max(record[key], (err.max() / top).item())
    return bool((err <= tol).all()), err.max().item()


def add_rows(rows):
    """One row summing the times and bounds of ``rows`` (the four
    projections of a layer)."""
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    for k in ("device_ms", "library_ms"):
        v = [r[k] for r in rows]
        total[k] = None if None in v else sum(v)
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return total


def phase_build():
    from fastforward_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    times = _build.build_all()
    for name in _build.SOURCES:
        _build.lib(name)
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in times.items()) or 'cached'})")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev):
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles, unpack_mult_nibbles

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows = {}
    L = 2  # stacked weights and caches: layer 1 of 2

    def randint(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype, device=dev)

    def stacked(K, N, g):
        w = randint(-128, 128, (L, K // 2, N))
        mult = randint(1, 16, (L, K // g, N))
        s_col = (torch.rand((L, N), generator=gen, device=dev) * 1e-3).contiguous()
        return w, mult, s_col

    def act(M, K):
        return torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)

    def dequantized(x_q, x_s):
        return (x_q.float() * x_s[:, None]).to(torch.bfloat16)

    # --- A4 GEMV (w4a4_2l decode), g512: M = 8, bench batch 192, 256 (the
    # largest GEMV prefill); the JSON row is one decode layer at M = 192.
    # Library: torch.matmul of the dequantized activations and weight.
    g = 512
    for M in (8, BATCH, 256):
        per = []
        for pname, (K, N) in PROJ.items():
            w, mult, s_col = stacked(K, N, g)
            mp = pack_mult_nibbles(mult).contiguous()
            x_q, x_s = mm.quantize_rowwise_a4(act(M, K))
            xb = dequantized(x_q, x_s)
            w_bf16 = mm.dequantize_int4_vertical_reference(w[1], mult[1].float() * s_col[1][None, :],
                                                           g)
            nbytes = K * N // 2 + mp[1].numel() * 4 + N * 4 + M * K + M * 4 + M * N * 2
            per.append(measure(
                "a4_gemv", f"{pname} M={M} K={K} N={N}",
                lambda: mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, mp, s_col, 1, group_size=g),
                lambda: mm.matmul_w4a4_2l_reference(x_q, x_s, w[1], unpack_mult_nibbles(mp[1], K // g),
                                                    s_col[1], None, g),
                nbytes, 2 * M * K * N, INT8_OPS_PER_S, bit_equal,
                library=lambda: torch.matmul(xb, w_bf16)))
            del w_bf16
        if M == BATCH:
            rows["a4_gemv"] = add_rows(per)

    # --- W4A8 two-level GEMV (w4a8_2l decode), stacked, g128, M = 192 and
    # 8, on flat and pre-blocked (panels of PANEL) weights: every route of
    # the stacked GEMV (the default call on either layout, the manual
    # stream at 2 and 4 stages, split-W) under its flags; the JSON rows are
    # one decode layer at M = 192 (the manual stream at 4 stages, (n)'s)
    g = 128
    # (route, layout, flags, variant, JSON row at M = 192); the plain
    # version, the same for every route, is timed over 20 calls for the
    # first and 5 for the others
    routes = (("w4a8_gemv_stacked", "flat", {}, "", True),
              ("w4a8_gemv_preblocked", "pre", {}, "", True),
              ("w4a8_gemv_manual", "pre", {"FF_2L_MANUAL": "2"}, " nbuf=2", False),
              ("w4a8_gemv_manual", "pre", {"FF_2L_MANUAL": "4"}, " nbuf=4", True),
              ("w4a8_gemv_splitw", "flat", FLAGS_O, "", True),
              ("w4a8_gemv_dotraw", "flat", FLAGS_P, " flat", True),
              ("w4a8_gemv_dotraw", "pre", FLAGS_P, f" bn={PANEL}", False),
              ("w4a8_gemv_concat", "flat", FLAGS_Q, " cp=4 flat", True),
              ("w4a8_gemv_concat", "pre", FLAGS_Q, f" cp=4 bn={PANEL}", False),
              ("w4a8_gemv_concat", "flat", {"FF_2L_CONCAT_PAIRS": "3"}, " cp=3 flat", False))
    for M in (BATCH, 8):
        per = collections.defaultdict(list)
        for pname, (K, N) in PROJ.items():
            w, mult, s_col = stacked(K, N, g)
            w4 = mm.preblock_stacked(w, PANEL)
            mp = pack_mult_nibbles(mult).contiguous()
            x_q, x_s = mm.quantize_rowwise(act(M, K))
            xb = dequantized(x_q, x_s)
            w_bf16 = mm.dequantize_int4_paired_reference(w[1], mult[1].float() * s_col[1][None, :], g)
            nbytes = K * N // 2 + mp[1].numel() * 4 + N * 4 + M * K + M * 4 + M * N * 2
            plan = mm.mma_plan(M, K, N, g, "paired")  # the manual stream's
            for i, (name, layout, flags, variant, _) in enumerate(routes):
                label = f"{pname} M={M} K={K} N={N}"
                if layout == "pre":
                    label += f" bn={PANEL}"
                if "FF_2L_MANUAL" in flags:
                    nbuf = int(flags["FF_2L_MANUAL"])
                    label += (f" nbuf={nbuf} (ring depth {mm.manual_depth(plan, nbuf)}, "
                              f"{plan.n_split} splits)")
                if "FF_2L_CONCAT_PAIRS" in flags:
                    cp = int(flags["FF_2L_CONCAT_PAIRS"])
                    label += f" {cp} pairs a unit ({K // (2 * g)} pairs)"
                wt = w4 if layout == "pre" else w
                with flag_env(**flags):
                    r = measure(
                        name, label,
                        lambda wt=wt: mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, wt, mp, s_col, 1,
                                                                     group_size=g),
                        lambda: mm.matmul_w4a8_2l_reference(
                            x_q, x_s, w[1], unpack_mult_nibbles(mp[1], K // g), s_col[1], None, g,
                            paired=True),
                        nbytes, 2 * M * K * N, INT8_OPS_PER_S, bit_equal,
                        library=lambda: torch.matmul(xb, w_bf16), plain_n=20 if i == 0 else 5)
                per[name, variant].append(r)
            if M == BATCH:  # the pre-blocked prefill dequant
                nb = K * N // 2 + (K // g) * N + N * 4 + K * N * 2
                per["dequant_paired_preblocked", ""].append(measure(
                    "dequant_paired_preblocked", f"{pname} K={K} N={N} g={g} bn={PANEL}",
                    lambda: mm.dequantize_int4_paired_stacked(w4, mult, s_col, 1, group_size=g),
                    lambda: mm.dequantize_int4_paired_reference(
                        w[1], mult[1].float() * s_col[1][None, :], g),
                    nb, K * N, F32_OPS_PER_S, bit_equal))
            del w, w4, w_bf16
        in_json = {(r[0], r[3]) for r in routes if r[4]} | {("dequant_paired_preblocked", "")}
        for (name, variant), r in per.items():
            total = add_rows(r)
            log(f"{name}{variant} M={M}, four projections: "
                f"{total['ms']:.4f} ms, device {fmt_ms(total['device_ms'])}, bound "
                f"{max(total['bytes_ms'], total['ops_ms']):.4f} ms, library "
                f"{fmt_ms(total['library_ms'])}")
            if M == BATCH and (name, variant) in in_json:
                rows[name] = total
        torch.cuda.empty_cache()

    # --- Prefill dequant: vertical (w4a4_2l, g512) and paired (w4a8_2l,
    # g128), the four projections of a layer
    for name, layout, g in (("dequant_vertical", "vertical", 512), ("dequant_paired", "paired", 128)):
        kern_fn = getattr(mm, f"dequantize_int4_{layout}_stacked")
        plain_fn = getattr(mm, f"dequantize_int4_{layout}_reference")
        per = []
        for pname, (K, N) in PROJ.items():
            w, mult, s_col = stacked(K, N, g)
            nbytes = K * N // 2 + (K // g) * N + N * 4 + K * N * 2
            per.append(measure(
                name, f"{pname} K={K} N={N} g={g}",
                lambda: kern_fn(w, mult, s_col, 1, group_size=g),
                lambda: plain_fn(w[1], mult[1].float() * s_col[1][None, :], g),
                nbytes, K * N, F32_OPS_PER_S, bit_equal))
        rows[name] = add_rows(per)

    # --- W4A8 two-level lm_head, paired, N = 128256, g512: M = 8 and 192,
    # f32 and bf16 logits (the tensor-core GEMV, row 5) and the argmax head
    # (row 4); the JSON rows are the f32 GEMV (the prefill's) and the argmax
    # head (the decode step's) at M = 192. Library: torch.matmul of the
    # dequantized activations and weight.
    K, N, g = 4096, 128256, 512
    w = randint(-128, 128, (K // 2, N))
    mult = randint(1, 16, (K // g, N))
    s_col = torch.rand((N,), generator=gen, device=dev) * 1e-3
    w_bf16 = mm.dequantize_int4_paired_reference(w, mult.float() * s_col[None, :], g)
    for M in (8, BATCH):
        x_q, x_s = mm.quantize_rowwise(act(M, K))
        xb = dequantized(x_q, x_s)
        nbytes = K * N // 2 + K // g * N + N * 4 + M * K + M * 4
        for out_dtype in (torch.float32, torch.bfloat16):
            r = measure(
                "w4a8_gemv", f"lm_head {out_dtype} M={M}",
                lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, mult, s_col, g, out_dtype, paired=True),
                lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, g, out_dtype,
                                                    paired=True),
                nbytes + M * N * (4 if out_dtype == torch.float32 else 2), 2 * M * K * N,
                INT8_OPS_PER_S, bit_equal, library=lambda: torch.matmul(xb, w_bf16))
            if M == BATCH and out_dtype == torch.float32:
                rows["w4a8_gemv"] = r
        r = measure(
            "w4a8_gemv_argmax", f"lm_head argmax M={M}",
            lambda: mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, mult, s_col, g, paired=True),
            lambda: torch.argmax(mm.matmul_w4a8_2l_reference(
                x_q, x_s, w, mult, s_col, None, g, torch.float32, paired=True), dim=-1).to(torch.int32),
            nbytes + M * 4, 2 * M * K * N, INT8_OPS_PER_S, bit_equal)
        if M == BATCH:
            rows["w4a8_gemv_argmax"] = r
    del w_bf16
    _mma_checks(dev, gen, randint)

    # --- KV append and flash decode: Hkv=8, G=4, d=128, S=512, layer 1 of
    # 2; B=8 with lengths 1..300, and the bench decode (B=192, lengths
    # 129..160); the JSON rows are the bench decode's
    Hkv, G, d, S = 8, 4, 128, SLAB
    H = Hkv * G
    for B, lo, hi in ((8, 1, 301), (BATCH, PROMPT + 1, PROMPT + STEPS + 1)):
        kc = randint(-128, 128, (L, B, Hkv, S, d))
        vc = randint(-128, 128, (L, B, Hkv, S, d))
        ks = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
        vs = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
        kn, vn = randint(-128, 128, (B, Hkv, 1, d)), randint(-128, 128, (B, Hkv, 1, d))
        ksn = torch.rand((B, Hkv, 1), generator=gen, device=dev)
        vsn = torch.rand((B, Hkv, 1), generator=gen, device=dev)
        lengths = torch.randint(lo, hi, (B,), generator=gen, device=dev, dtype=torch.int32)
        lengths[0], lengths[1] = lo, hi - 1
        starts = (lengths - 1).contiguous()
        bufs = [t.clone() for t in (kc, vc, ks, vs)]

        def append_check(out, ref):
            return all(torch.equal(a, r) for a, r in zip(out, ref)), \
                max(max_err(a, r) for a, r in zip(out, ref))

        # the kernel and the plain version each write their own copy of the cache
        ref_bufs = [t.clone() for t in (kc, vc, ks, vs)]
        r_app = measure(
            "kv_append", f"B={B} Hkv={Hkv} d={d} S={S}",
            lambda: kvu.kv_append_decode_int8_stacked(*bufs, kn, vn, ksn, vsn, starts, 1),
            lambda: kvu.kv_append_decode_stacked_reference(*ref_bufs, kn, vn, ksn, vsn, starts, 1),
            2 * 2 * B * Hkv * (d + 4) + B * 4, 0, INT8_OPS_PER_S, append_check)
        q = torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
        live = int(lengths.sum().item())
        kd = (kc[1].float() * ks[1][..., None]).to(torch.bfloat16)
        vd = (vc[1].float() * vs[1][..., None]).to(torch.bfloat16)
        amask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        r_dec = measure(
            "flash_decode", f"B={B} H={H} Hkv={Hkv} d={d} S={S} lengths {lo}..{hi - 1}",
            lambda: att.flash_decode_int8_stacked(q, kc, ks, vc, vs, lengths, 1),
            lambda: att.flash_decode_int8_reference(q, kc[1], ks[1], vc[1], vs[1], lengths),
            live * Hkv * 2 * (d + 4) + 2 * B * H * d * 2 + B * 4, 4 * live * G * d * Hkv,
            F32_OPS_PER_S, within_rtol,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], kd, vd, attn_mask=amask, enable_gqa=True))
        del kc, vc, kd, vd, bufs, ref_bufs
        if B == BATCH:
            rows["kv_append"], rows["flash_decode"] = r_app, r_dec

    # --- Flash prefill: bench.py's prefill (B=192, T=128, starts 0) and a
    # ragged chunk (T=77, starts 0..300) over one layer of a 512-token slab
    for B, T, smax in ((BATCH, PROMPT, 0), (16, 77, 300)):
        k = randint(-128, 128, (B, Hkv, S, d))
        v = randint(-128, 128, (B, Hkv, S, d))
        ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
        q = torch.randn((B, H, T, d), generator=gen, device=dev).to(torch.bfloat16)
        starts = torch.randint(0, smax + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        pos = starts[:, None].long() + torch.arange(T, device=dev)[None, :]        # (B, T)
        seen = torch.clamp(pos + 1, max=S)                                           # keys per row
        live_rows = int(torch.clamp(starts.long() + T, max=S).sum().item())
        nbytes = 2 * B * H * T * d * 2 + live_rows * Hkv * 2 * (d + 4) + B * 4
        ops = 4 * H * d * int(seen.sum().item())
        kd = (k.float() * ks[..., None]).to(torch.bfloat16)
        vd = (v.float() * vs[..., None]).to(torch.bfloat16)
        cmask = (torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None])[:, None]
        r = measure(
            "flash_prefill", f"B={B} H={H} Hkv={Hkv} T={T} S={S} starts 0..{smax}",
            lambda: att.flash_prefill(q, k, ks, v, vs, starts),
            lambda: att.flash_prefill_reference(q, k, ks, v, vs, starts),
            nbytes, ops, BF16_OPS_PER_S, within_rtol,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kd, vd, attn_mask=cmask, enable_gqa=True))
        del k, v, kd, vd
        if B == BATCH:
            rows["flash_prefill"] = r
    torch.cuda.empty_cache()
    rows.update(_paged_kernels(dev, gen, randint))
    rows.update(_fused_tail_kernel(dev, gen, randint))
    torch.cuda.empty_cache()
    rows.update(_float_scale_kernels(dev, gen, randint))
    torch.cuda.empty_cache()
    rows.update(_float_scale_group_kernels(dev, gen, randint))
    torch.cuda.empty_cache()
    rows.update(_two_level_any_kernels(dev, gen, randint))
    rows.update(_fused_append_kernels(dev, gen, randint))
    rows.update(_layer_kernels(dev, gen, randint))
    torch.cuda.empty_cache()
    rows.update(_fused_route_kernels(dev, gen, randint))
    torch.cuda.empty_cache()
    rows.update(_tiled_w4a16_kernel(dev, gen, randint))
    torch.cuda.empty_cache()
    rows.update(_probe_kernels(dev))
    torch.cuda.empty_cache()
    return rows


def _mma_checks(dev, gen, randint):
    """The tensor-core tile's entries bit-equal to their plain versions at
    the serve runs' shapes, M = 1, 8, 17, 192 and 256: the W4A8 GEMV
    (matmul_w4a8_2l_reference) on the lm_head (K 4096, N 128256) paired at
    g512 and g128 and unpaired at g128, f32 and bf16, on the seven unfused
    projections of a layer (LAYER_PROJ) unpaired at g128, bf16, and on the
    four fused projections (PROJ) through every route of the stacked GEMV,
    bf16 (layer 1 of 2): flat, pre-blocked in PANEL- and 128-column panels,
    the manual stream at nbuf 2 and 4, split-W, dot-raw on either layout,
    concat-pairs at 4 (flat) and 3 (pre-blocked) pairs a unit; the A4
    GEMV (matmul_w4a4_2l_reference) on PROJ at g512, layer 1 of 2, and on
    one g128 and one g32 shape; the argmax head (torch.argmax of the f32
    reference logits) on the lm_head at g512 and g128, with tied columns
    within and across 128-column blocks, a row of zeros (a tie over the
    whole row) and a row whose scale is NaN. Each launch counted."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles

    n = 0
    ms = (1, 8, 17, BATCH, 256)

    def check(what, name, kern, plain):
        nonlocal n
        before = _build.launch_counts[name]
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, ref) or _build.launch_counts[name] != before + 1:
            raise AssertionError(f"{name} {what}: not bit-equal to its plain version (err "
                                 f"{max_err(out, ref):.3g}) or not launched once")
        n += 1

    def layer(K, N, g, L=None):
        shape = (K // 2, N) if L is None else (L, K // 2, N)
        mshape = (K // g, N) if L is None else (L, K // g, N)
        s_shape = (N,) if L is None else (L, N)
        return (randint(-128, 128, shape), randint(1, 16, mshape),
                torch.rand(s_shape, generator=gen, device=dev) * 1e-3)

    for g, paired in ((512, True), (128, True), (128, False)):
        K, N = 4096, VOCAB
        w, mult, s_col = layer(K, N, g)
        name = "w4a8_gemv" if paired else "w4a8_gemv_unpaired"
        for M in ms:
            x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
            for dt in (torch.float32, torch.bfloat16):
                check(f"lm_head g{g} M={M} {dt}", name,
                      lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, mult, s_col, g, dt,
                                                     paired=paired),
                      lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, g, dt,
                                                          paired=paired))
        del w, mult
        torch.cuda.empty_cache()
    g = 128
    for pname, (K, N) in LAYER_PROJ.items():
        w, mult, s_col = layer(K, N, g)
        for M in ms:
            x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
            check(f"{pname} M={M}", "w4a8_gemv_unpaired",
                  lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, mult, s_col, g, paired=False),
                  lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, g,
                                                      paired=False))
    for pname, (K, N) in PROJ.items():
        w, mult, s_col = layer(K, N, g, L=2)
        w4, mp = mm.preblock_stacked(w, PANEL), pack_mult_nibbles(mult).contiguous()
        w128 = mm.preblock_stacked(w, 128)
        # every route of the stacked GEMV: (launch count, flags, weights)
        routes = [("w4a8_gemv_manual", {"FF_2L_MANUAL": str(nbuf)}, w4) for nbuf in (2, 4)]
        routes += [("w4a8_gemv_stacked", {}, w), ("w4a8_gemv_preblocked", {}, w4),
                   ("w4a8_gemv_preblocked", {}, w128), ("w4a8_gemv_splitw", FLAGS_O, w),
                   ("w4a8_gemv_dotraw", FLAGS_P, w), ("w4a8_gemv_dotraw", FLAGS_P, w4),
                   ("w4a8_gemv_concat", FLAGS_Q, w),
                   ("w4a8_gemv_concat", {"FF_2L_CONCAT_PAIRS": "3"}, w4)]
        for M in ms:
            x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
            ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], mult[1], s_col[1], None, g,
                                              paired=True)
            for name, flags, wt in routes:
                with flag_env(**flags):
                    check(f"{pname} M={M} {flags} {tuple(wt.shape)}", name,
                          lambda wt=wt: mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, wt, mp, s_col, 1,
                                                                       group_size=g),
                          lambda: ref)
        del w, w4, w128
    torch.cuda.empty_cache()
    n8, t_a4 = n, time.perf_counter()
    # the A4 GEMV (vertical layout)
    a4_shapes = [*((kn, 512) for kn in PROJ.values()), ((4096, 6144), 128), ((1024, 4100), 32)]
    for (K, N), g in a4_shapes:
        w, mult, s_col = layer(K, N, g, L=2)
        mp = pack_mult_nibbles(mult).contiguous()
        for M in ms:
            x_q, x_s = mm.quantize_rowwise_a4(torch.randn((M, K), generator=gen, device=dev))
            check(f"K={K} N={N} g{g} M={M}", "a4_gemv",
                  lambda: mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, mp, s_col, 1, group_size=g),
                  lambda: mm.matmul_w4a4_2l_reference(x_q, x_s, w[1], mult[1], s_col[1], None, g))
        del w
    n_a4, t_argmax = n - n8, time.perf_counter()
    # the argmax head: column 3 copied to 77 (its block), 5000 and VOCAB - 2
    # (the ragged last block), scaled to carry the maximum where their sum
    # is positive
    tied = [3, 77, 5000, VOCAB - 2]
    for g in (512, 128):
        K, N = 4096, VOCAB
        w, mult, s_col = layer(K, N, g)
        w[:, tied], mult[:, tied], s_col[tied] = w[:, 3:4], mult[:, 3:4], 1.0
        for M in ms:
            x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
            x_q[0] = 0
            if M > 1:
                x_s[M - 1] = float("nan")
            check(f"lm_head argmax g{g} M={M}", "w4a8_gemv_argmax",
                  lambda: mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, mult, s_col, g, paired=True),
                  lambda: torch.argmax(mm.matmul_w4a8_2l_reference(
                      x_q, x_s, w, mult, s_col, None, g, torch.float32, paired=True),
                      dim=-1).to(torch.int32))
        del w, mult
        torch.cuda.empty_cache()
    t_end = time.perf_counter()
    log(f"tensor-core tile: {n} calls bit-equal: {n8} W4A8 (lm_head g512, g128 paired and g128 "
        f"unpaired; LAYER_PROJ unpaired; PROJ through the stacked GEMV's six routes: flat, "
        f"pre-blocked at {PANEL} and 128, the manual stream at nbuf 2 and 4, split-W, dot-raw "
        f"and concat-pairs at 4 and 3 pairs a unit), {n_a4} A4 (PROJ g512, "
        f"g128, g32; {t_argmax - t_a4:.1f} s), {n - n8 - n_a4} argmax head (g512, g128; ties, "
        f"a NaN row; {t_end - t_argmax:.1f} s); M = {ms}")


def _tiled_w4a16_kernel(dev, gen, randint):
    """The tiled W4A16 kernel (off the serving route) at bench.py's w4a16
    prefill: M = 192 x 128 rows, the four projections, g128, bf16 out;
    held within W4_GEMV_RTOL and one bf16 ulp of its plain version (timed
    over 2 calls), its bias epilogue exactly (gate/up); wgmma (HGMMA) in
    its kernel's SASS, or the phase fails. Library: one torch.matmul on the
    weight dequantized beforehand as the kernel rounds it, bf16(bf16(v) *
    bf16(s)); the route it would replace (the halves dequant, #15, then
    torch.matmul) is logged beside it."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import unpack_int4

    _require_sass(_build._lib_path("w4a16_gemm"), "w4a16_wgmma_kernel", "HGMMA")
    g, M = 128, BATCH * PROMPT
    check = functools.partial(w4_close, record=W4A16_TILED_REL_ERR)
    per, route = [], 0.0
    for pname, (K, N) in PROJ.items():
        w = randint(-128, 128, (K // 2, N))
        s = torch.rand((K // g, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w_bf16 = (unpack_int4(w, g).to(torch.bfloat16).reshape(K // g, g, N)
                  * s.to(torch.bfloat16)[:, None, :]).reshape(K, N)
        per.append(measure(
            "w4a16_gemm", f"{pname} M={M} K={K} N={N} g={g}",
            lambda: mm.matmul_w4a16_tiled(x, w, s, None, g),
            lambda: mm.matmul_w4a16_tiled_reference(x, w, s, None, g),
            M * K * 2 + K * N // 2 + s.numel() * 4 + M * N * 2, 2 * M * K * N, BF16_OPS_PER_S,
            check, library=lambda: torch.matmul(x, w_bf16), plain_n=2))
        del w_bf16
        ms = median_ms(lambda: torch.matmul(x, mm.dequantize_int4(w, s, g)))
        route += ms
        log(f"w4a16_gemm {pname}: the route it would replace (dequant_halves + torch.matmul) "
            f"{ms:.4f} ms")
        if pname == "gate_up":
            bias = torch.randn((N,), generator=gen, device=dev)
            out = mm.matmul_w4a16_tiled(x, w, s, None, g)
            if not torch.equal(mm.matmul_w4a16_tiled(x, w, s, bias, g),
                               (out.float() + bias).to(torch.bfloat16)):
                raise AssertionError("w4a16_gemm: the bias epilogue is not f32(out) + bias rounded")
            log("w4a16_gemm gate_up: bias epilogue bit-equal to f32(out) + bias, rounded")
            del out
        del w, s, x
        torch.cuda.empty_cache()
    total = add_rows(per)
    log(f"w4a16_gemm: largest error relative to the largest plain output "
        f"{dict(W4A16_TILED_REL_ERR)} (limit {W4_GEMV_RTOL}, bf16 one ulp more); four "
        f"projections: kernel {total['ms']:.4f} ms, device {fmt_ms(total['device_ms'])}, one "
        f"torch.matmul on the pre-dequantized weight {total['library_ms']:.4f} ms, the dequant + "
        f"torch.matmul route {route:.4f} ms")
    return {"w4a16_gemm": total}


def _sass_mma(lib_path):
    """{kernel: {tensor-core or dp4a instruction: count}} of a built
    library, from cuobjdump's SASS; empty when cuobjdump is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    found, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"\b([IH]G?MMA\.[\w.]+|IDP4A[\w.]*)", line)
        if m and name is not None:
            found.setdefault(name, collections.Counter())[m.group(1)] += 1
    return found


def _require_sass(lib_path, kernel, inst, forbid=None):
    """Fail unless every function of the library whose name holds
    ``kernel`` issues tensor-core instructions starting ``inst`` (HGMMA:
    bf16 wgmma, IGMMA: int8 wgmma, IMMA: int8 mma.sync), and (``forbid``,
    e.g. IDP4A) unless
    no function of the library issues an instruction starting ``forbid``;
    log what each issues."""
    sass = _sass_mma(lib_path)
    found = {fn: c for fn, c in sass.items() if kernel in fn}
    for fn, counts in found.items():
        log(f"SASS of {fn[:90]}: instructions {dict(counts)}")
    if not found or not all(any(k.startswith(inst) for k in c) for c in found.values()):
        raise AssertionError(f"{kernel} in {lib_path}: no {inst} in the SASS of every instance "
                             f"({len(found)} found)")
    bad = sorted(fn for fn, c in sass.items() if forbid and any(k.startswith(forbid) for k in c))
    if bad:
        raise AssertionError(f"{lib_path}: {forbid} in the SASS of {bad}")


def _probe_kernels(dev):
    """Every route of the int4/int8 dot probe at its default knobs (192 x
    512 activations, 6 panels of 512 x 512, 16 rounds) in as many copies as
    put two 64-row blocks on each SM: bit-equal to its plain version,
    timed over PROBE_SCAN chained calls (TOP/s for the card and per SM);
    and the tensor-core instructions in each route's SASS."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.scripts import probe_int4 as pr

    knobs = pr.Knobs()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    copies = pr.default_copies(knobs.bm, sms)
    x, w = pr.inputs(knobs, copies, dev)
    ops = pr.ops_per_call(knobs, copies)
    log(f"probe: {copies} copies of ({knobs.bm},{knobs.k}) x {knobs.panels} panels x "
        f"{knobs.rounds} rounds = {ops / 1e12:.4f} TOP a call; {PROBE_SCAN} chained calls, "
        f"best of {PROBE_PAIRS} interleaved passes")
    rows = {}
    for (inst, int4), (ms, out, ref) in pr.time_routes(knobs, x, w, PROBE_SCAN,
                                                       PROBE_PAIRS).items():
        name = f"probe_{inst}{'_int4' if int4 and inst != 'mma_s4' else ''}"
        if not torch.equal(out, ref):
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        tops = ops / (ms * 1e-3) / 1e12
        log(f"probe {inst} {'int4' if int4 else 'int8'} form: {ms:.4f} ms a call, {tops:.1f} "
            f"TOP/s on the card, {tops / sms:.3f} TOP/s per SM; output bit-equal")
        wr = pr.prepare_weights(w, inst, int4)
        peak = BF16_OPS_PER_S if inst == "mma_bf16" else INT8_OPS_PER_S
        rows[name] = measure(
            name, f"{inst} {'int4' if int4 else 'int8'} form",
            lambda: pr.probe(x, wr, inst, int4, knobs.rounds),
            lambda: pr.probe_reference(x, w, int4, knobs.rounds),
            2 * x.numel() + wr.numel() * wr.element_size(), ops, peak, bit_equal, plain_n=3)
        rows[name]["tops"] = tops
    insts = {v: k for k, v in pr.INSTRUCTIONS.items()}
    for fn, counts in _sass_mma(_build._lib_path("probe_int4")).items():
        inst = fn.split("probe_kernelILi", 1)[-1].split("E", 1)[0]  # the INST argument
        log(f"probe SASS of the {insts.get(int(inst)) if inst.isdigit() else fn} kernel: "
            f"instructions {dict(counts)}")
    return rows


def _paged_kernels(dev, gen, randint):
    """Paged append and paged flash decode at the engine's decode: B = 32
    sequences, a pool of 39 pages of 256 tokens, one page each from a
    shuffled list, lengths 17..160, and two rows that walk both table
    columns (300 and 512 tokens, a second page each); layer 1 of 2."""
    from fastforward_tpu_torch.kernels import paged_attention as pa

    L, Hkv, G, d = 2, 8, 4, 128
    B, P, page, MP = ENGINE_SLOTS, ENGINE_PAGES, ENGINE_PAGE, ENGINE_MAXLEN // ENGINE_PAGE
    pools = [randint(-128, 128, (L, P, Hkv, page, d)) for _ in range(2)]
    pools += [torch.rand((L, P, Hkv, page), generator=gen, device=dev) * 0.05 for _ in range(2)]
    table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
    perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(torch.int32)
    table[:, 0] = perm[:B]
    table[4:6, 1] = perm[B:B + 2]
    lengths = torch.randint(17, 161, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1], lengths[4], lengths[5] = 17, 160, 300, MP * page
    rows = {}

    # append: row 2's table is all -1 (a retired slot: page 0), row 3 sits
    # past the table (pos // page >= MP: page 0 too, another row of it)
    pos = (lengths - 1).clone()
    table_a = table.clone()
    table_a[2] = -1
    pos[2], pos[3] = 5, MP * page + 9
    new = [randint(-128, 128, (B, Hkv, 1, d)) for _ in range(2)]
    new += [torch.rand((B, Hkv, 1), generator=gen, device=dev) for _ in range(2)]
    bufs = [t.clone() for t in pools]
    ref_bufs = [t.clone() for t in pools]

    def append_check(out, ref):
        return all(torch.equal(a, r) for a, r in zip(out, ref)), \
            max(max_err(a, r) for a, r in zip(out, ref))

    rows["paged_kv_append"] = measure(
        "paged_kv_append",
        f"B={B} P={P} page={page} Hkv={Hkv} d={d} (a -1 row, a row past the table, "
        "two rows on their second page)",
        lambda: pa.paged_kv_append_decode_int8(*bufs, *new, pos, table_a, 1),
        lambda: pa.paged_kv_append_reference(*ref_bufs, *new, pos, table_a, 1),
        2 * 2 * B * Hkv * (d + 4) + B * 4 + B * MP * 4, 0, INT8_OPS_PER_S, append_check)
    del bufs, ref_bufs

    # flash decode over the shuffled pages
    k, v, ks, vs = pools
    q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
    live = int(lengths.sum().item())

    def gathered(pool):
        return torch.stack([pa.gather_pages(pool[1], t) for t in table])
    kd = (gathered(k).float() * gathered(ks)[..., None]).to(torch.bfloat16)
    vd = (gathered(v).float() * gathered(vs)[..., None]).to(torch.bfloat16)
    S = MP * page
    amask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    rows["paged_flash_decode"] = measure(
        "paged_flash_decode",
        f"B={B} H={Hkv * G} Hkv={Hkv} d={d} page={page} lengths 17..160, 300, {MP * page}",
        lambda: pa.paged_flash_decode_int8(q, k, ks, v, vs, table, lengths, 1),
        lambda: pa.paged_flash_decode_reference(q, k[1], ks[1], v[1], vs[1], table, lengths),
        live * Hkv * 2 * (d + 4) + 2 * B * Hkv * G * d * 2 + B * 4 + B * MP * 4,
        4 * live * G * d * Hkv, F32_OPS_PER_S, within_rtol,
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=amask, enable_gqa=True))
    return rows


def _fused_tail_kernel(dev, gen, randint):
    """The fused W4A8 layer tail at the 8B widths, M = 8, 32 and 64 rows
    (the JSON row: M = 32, the engine's decode); layer 1 of 2. Its three
    products are the int8 tensor-core tile (IMMA in the SASS of the
    library's tile, no IDP4A in any of its kernels, or the phase fails); a
    call's device time is logged by kernel. Beside it, for information
    only, the port's unfused route on the same inputs (three stacked GEMVs
    on the same tile and torch glue), caller-visible and on the card."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles
    from fastforward_tpu_torch.serving.engine import _rms_norm

    _require_sass(_build._lib_path("fused_tail"), "w4a8_mma_kernel", "IMMA", forbid="IDP4A")

    L, H, inter, g, eps = 2, 4096, 14336, 128, 1e-5
    ops, nbytes_w = [], 0
    for K, N in ((H, H), (H, 2 * inter), (inter, H)):
        w = randint(-128, 128, (L, K // 2, N))
        mp = pack_mult_nibbles(randint(1, 16, (L, K // g, N))).contiguous()
        sc = torch.rand((L, N), generator=gen, device=dev) * (4.0 / K)
        ops += [w, mp, sc]
        nbytes_w += K * N // 2 + mp[1].numel() * 4 + N * 4
    norm = (torch.rand((L, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    rows = {}
    for M in (8, ENGINE_SLOTS, 64):
        attn = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        layer_ops = mm._fused_o_mlp_layer(norm, *ops, 1, g)
        diffs = {}

        def check(out, ref, _diffs=diffs):
            y, x1, hq, hs, x2, gs = ref
            ok = torch.equal(out[1], x1)
            for name, a, b in (("hq", out[2], hq), ("x2", out[4], x2)):
                d = (a.int() - b.int()).abs()
                _diffs[name] = (int(d.count_nonzero().item()), a.numel())
                ok = ok and d.max().item() <= 1 and _diffs[name][0] <= TAIL_LEVEL_SHARE * a.numel()
            ok_y, err = within_rtol(out[0], y)
            return ok and ok_y, err

        def unfused(attn=attn, x_res=x_res):
            o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp, dn_sc = ops
            x = x_res + mm.matmul_w4a8_2l_gemv_stacked(*mm.quantize_rowwise(attn), o_w, o_mp, o_sc,
                                                       1, group_size=g)
            gu = mm.matmul_w4a8_2l_gemv_stacked(*mm.quantize_rowwise(_rms_norm(x, norm[1], eps)),
                                                gu_w, gu_mp, gu_sc, 1, group_size=g)
            gated = torch.nn.functional.silu(gu[:, :inter].float()).to(x.dtype) * gu[:, inter:]
            return x + mm.matmul_w4a8_2l_gemv_stacked(*mm.quantize_rowwise(gated), dn_w, dn_mp,
                                                      dn_sc, 1, group_size=g)

        def kern(attn=attn, x_res=x_res):
            return mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g, eps)

        r = measure(
            "fused_o_mlp", f"M={M} H={H} inter={inter} g={g}", kern,
            lambda attn=attn, x_res=x_res: mm._fused_o_mlp_parts(attn.float(), x_res.float(),
                                                                 *layer_ops, group_size=g, eps=eps),
            nbytes_w + H * 2 + M * H * 2 * 3, 2 * M * (H * H + H * 2 * inter + inter * H),
            INT8_OPS_PER_S, check)
        r["unfused_ms"] = median_ms(unfused)
        r["unfused_device_ms"] = device_ms(unfused)
        r["level_diffs"] = dict(diffs)
        log(f"fused_o_mlp M={M}: x1 bit-equal; int8 elements one level off: "
            + ", ".join(f"{k} {n} of {t}" for k, (n, t) in diffs.items())
            + f"; unfused route (3 stacked GEMVs on the tile + torch glue) {r['unfused_ms']:.4f} "
            f"ms, device {fmt_ms(r['unfused_device_ms'])}")
        _log_by_kernel(f"fused_o_mlp M={M}", kern)
        if M == ENGINE_SLOTS:
            rows["fused_o_mlp"] = r
    return rows


def _log_by_kernel(what, fn, n=20):
    """Log the device time of one call of ``fn`` by kernel, from a profile
    of ``n`` calls that recorded every launch (`launches_per_call`)."""
    try:
        parts = _profile(fn, n, launches_per_call(fn))[1]
    except ProfileLost as e:
        log(f"{what}, device ms a call by kernel: not measured ({e})")
        return
    log(f"{what}, device ms a call by kernel: "
        + "; ".join(f"{_kernel_name(k)} {ms:.4f} (x{c:.0f})" for ms, c, k in parts))


def _greedy_ids_agree(what, logits, ref):
    """The argmax ids of ``logits`` equal those of the plain ``ref`` in every
    row whose plain top-2 margin exceeds the largest logit error."""
    err = (logits - ref).abs().max().item()
    top2 = torch.topk(ref, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    differ = torch.argmax(logits, dim=-1) != torch.argmax(ref, dim=-1)
    wrong = (differ & (margin > err)).nonzero().flatten().tolist()
    log(f"{what}: {int(differ.sum())} of {len(differ)} argmax ids differ (max logit error "
        f"{err:.3g}); rows whose margin exceeds it: {wrong}")
    if wrong:
        raise AssertionError(f"{what}: argmax ids differ where the margin exceeds the error: {wrong}")


def _int_mm_yardstick(what, x_q, w):
    """One torch._int_mm computing x_q @ w (int32, no scales) on the weight
    as it lies (N-contiguous) and on a K-major copy made outside the timed
    window (the layout cuBLASLt's int8 GEMM takes): both logged, the faster
    returned."""
    wt = w.t().contiguous()
    n_major = median_ms(lambda: torch._int_mm(x_q, w))
    k_major = median_ms(lambda: torch._int_mm(x_q, wt.t()))
    del wt
    log(f"{what}: library torch._int_mm on the N-contiguous weight {n_major:.4f} ms, on a "
        f"K-major copy {k_major:.4f} ms")
    return min(n_major, k_major)


def _float_scale_kernels(dev, gen, randint):
    """The kernels of the float-scale modes at the 8B shapes, g128: the
    W8A8 GEMM, the W4A8 halves GEMV and the W4 GEMV over the four fused
    projections at M = 192 (the JSON rows) and the lm_head at M = 192
    (f32 logits); the W8A8 GEMM and the W4A8 GEMV (both int8 wgmma: IGMMA
    and no IMMA in their libraries' SASS, or the phase fails) also
    bit-equal at M = 1, 8, 17 and 256 on the four projections and the
    lm_head; the W4 GEMV again over the four projections at M = 8 (its
    SASS must show HGMMA: wgmma); the W8A8 GEMM at the prefill's M =
    24,576; the halves dequant (w4a8 and w4a16 prefill) over the four
    projections. Library for the int8 products: the faster of
    torch._int_mm on the N-contiguous weight and on a K-major copy
    (`_int_mm_yardstick`)."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import unpack_int4

    g, M = 128, BATCH
    rows, shapes = {}, dict(PROJ, lm_head=(PROJ["qkv"][0], VOCAB))
    _require_sass(_build._lib_path("w8a8_gemm"), "w8a8_wgmma_kernel", "IGMMA", forbid="IMMA")
    _require_sass(_build._lib_path("w4a8_halves"), "w4a8_wgmma_kernel", "IGMMA", forbid="IMMA")

    def w4(K, N):
        w = randint(-128, 128, (K // 2, N))
        s = torch.rand((K // g, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
        return w, s

    def act(M, K):
        return torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)

    # rows 19 and 16 at the decode's edges: one row, an 8-row tile, a
    # ragged 17, the GEMV limit (two row tiles of 128; three row blocks)
    t0, calls = time.perf_counter(), 0
    for pname, (K, N) in shapes.items():
        out_dtype = torch.float32 if pname == "lm_head" else torch.bfloat16
        w8 = randint(-127, 128, (K, N))
        ws = torch.rand((N,), generator=gen, device=dev) * (0.02 / K ** 0.5)
        wq, s = w4(K, N)
        for Me in (1, 8, 17, 256):
            x_q, x_s = mm.quantize_rowwise(act(Me, K))
            for name, out, ref in (
                    ("w8a8_gemm", mm.matmul_w8a8(x_q, x_s, w8, ws, out_dtype=out_dtype),
                     mm.matmul_w8a8_reference(x_q, x_s, w8, ws, out_dtype=out_dtype)),
                    ("w4a8_gemv_halves", mm.matmul_w4a8_gemv(x_q, x_s, wq, s, g, out_dtype),
                     mm.matmul_w4a8_reference(x_q, x_s, wq, s, None, g, out_dtype))):
                calls += 1
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} {pname} M={Me}: kernel disagrees with its plain "
                                         f"version (err {max_err(out, ref):.3g})")
        del w8, wq
    torch.cuda.empty_cache()
    log(f"w8a8_gemm, w4a8_gemv_halves: bit-equal to their plain versions at M = 1, 8, 17, 256 on "
        f"the four projections and the f32 lm_head ({calls} calls, {time.perf_counter() - t0:.1f} s)")

    per = {k: [] for k in ("w8a8_gemm", "w4a8_gemv_halves", "w4_gemv", "dequant_halves")}
    for pname, (K, N) in shapes.items():
        head = pname == "lm_head"
        out_dtype = torch.float32 if head else torch.bfloat16
        osz = M * N * (4 if head else 2)
        x = act(M, K)
        x_q, x_s = mm.quantize_rowwise(x)
        w8 = randint(-127, 128, (K, N))
        ws = torch.rand((N,), generator=gen, device=dev) * (0.02 / K ** 0.5)
        r = measure(
            "w8a8_gemm", f"{pname} M={M} K={K} N={N} {out_dtype}",
            lambda: mm.matmul_w8a8(x_q, x_s, w8, ws, out_dtype=out_dtype),
            lambda: mm.matmul_w8a8_reference(x_q, x_s, w8, ws, out_dtype=out_dtype),
            M * K + M * 4 + K * N + N * 4 + osz, 2 * M * K * N, INT8_OPS_PER_S, bit_equal)
        r["library_ms"] = _int_mm_yardstick(f"w8a8_gemm {pname}", x_q, w8)
        if not head:
            per["w8a8_gemm"].append(r)
        del w8
        w, s = w4(K, N)
        w_int8 = unpack_int4(w, g)
        r = measure(
            "w4a8_gemv_halves", f"{pname} M={M} K={K} N={N} g={g} {out_dtype}",
            lambda: mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, out_dtype),
            lambda: mm.matmul_w4a8_reference(x_q, x_s, w, s, None, g, out_dtype),
            M * K + M * 4 + K * N // 2 + s.numel() * 4 + osz, 2 * M * K * N, INT8_OPS_PER_S,
            bit_equal)
        r["library_ms"] = _int_mm_yardstick(
            f"w4a8_gemv_halves {pname} (the unpacked int8 weight: no group scales)", x_q, w_int8)
        if not head:
            per["w4a8_gemv_halves"].append(r)
        del w_int8
        w_bf16 = mm.dequantize_int4_reference(w, s, g)
        r = measure(
            "w4_gemv", f"{pname} M={M} K={K} N={N} g={g} {out_dtype}",
            lambda: mm.matmul_w4_gemv(x, w, s, g, out_dtype),
            lambda: mm.matmul_w4_gemv_reference(x, w, s, g, out_dtype),
            M * K * 2 + K * N // 2 + s.numel() * 4 + osz, 2 * M * K * N, BF16_OPS_PER_S,
            w4_close, library=lambda: torch.matmul(x, w_bf16))
        if head:
            _greedy_ids_agree("w4_gemv lm_head", mm.matmul_w4_gemv(x, w, s, g, out_dtype),
                              mm.matmul_w4_gemv_reference(x, w, s, g, out_dtype))
        else:
            per["w4_gemv"].append(r)
            per["dequant_halves"].append(measure(
                "dequant_halves", f"{pname} K={K} N={N} g={g}",
                lambda: mm.dequantize_int4(w, s, g),
                lambda: mm.dequantize_int4_reference(w, s, g),
                K * N // 2 + s.numel() * 4 + K * N * 2, K * N, F32_OPS_PER_S, bit_equal))
        del w_bf16, w, s
    for name, r in per.items():
        rows[name] = add_rows(r)

    # The W4 GEMV (wgmma, a call's weights dequantized once) at the decode
    # of bench.py's 8-row batch: the four projections, bytes-bound
    from fastforward_tpu_torch.kernels import _build

    _require_sass(_build._lib_path("w4_gemv"), "w4_gemv_wgmma_kernel", "HGMMA")
    for M in (BATCH, 8):
        plan = mm.w4_plan(M, *PROJ["qkv"], g)
        got = tuple(_build.lib("w4_gemv").ff_w4_gemv_clusters(M, plan.depth, c) for c in range(1, 9))
        log(f"w4_gemv M={M}: clusters of 1-8 blocks the card runs at once {got}; the plan's "
            f"table {mm.W4_CLUSTERS[plan.per_sm]}")
    small = []
    for pname, (K, N) in PROJ.items():
        x = act(8, K)
        w, s = w4(K, N)
        w_bf16 = mm.dequantize_int4_reference(w, s, g)
        small.append(measure(
            "w4_gemv", f"{pname} M=8 K={K} N={N} g={g} bf16 "
                       f"({mm.w4_plan(8, K, N, g).n_split} splits)",
            lambda: mm.matmul_w4_gemv(x, w, s, g), lambda: mm.matmul_w4_gemv_reference(x, w, s, g),
            8 * K * 2 + K * N // 2 + s.numel() * 4 + 8 * N * 2, 2 * 8 * K * N, BF16_OPS_PER_S,
            w4_close, library=lambda: torch.matmul(x, w_bf16)))
        del w, s, w_bf16
    rows["w4_gemv"]["m8"] = add_rows(small)
    r8 = rows["w4_gemv"]["m8"]
    log(f"w4_gemv four projections M=8: {r8['ms']:.4f} ms, device {fmt_ms(r8['device_ms'])}, "
        f"bound {max(r8['bytes_ms'], r8['ops_ms']):.4f} ms, library {fmt_ms(r8['library_ms'])}")
    log(f"w4_gemv: largest error relative to the largest plain output {dict(W4_REL_ERR)} "
        f"(limit {W4_GEMV_RTOL}, bf16 one ulp more)")

    # The W8A8 GEMM at the prefill (bench.py's 192 x 128 rows); the plain
    # version (an f64 product) over 2 calls
    MP = BATCH * PROMPT
    pre = []
    for pname, (K, N) in PROJ.items():
        x_q, x_s = mm.quantize_rowwise(act(MP, K))
        w8 = randint(-127, 128, (K, N))
        ws = torch.rand((N,), generator=gen, device=dev) * (0.02 / K ** 0.5)
        pre.append(measure(
            "w8a8_gemm", f"prefill {pname} M={MP} K={K} N={N}",
            lambda: mm.matmul_w8a8(x_q, x_s, w8, ws),
            lambda: mm.matmul_w8a8_reference(x_q, x_s, w8, ws),
            MP * K + MP * 4 + K * N + N * 4 + MP * N * 2, 2 * MP * K * N, INT8_OPS_PER_S,
            bit_equal, plain_n=2))
        pre[-1]["library_ms"] = _int_mm_yardstick(f"w8a8_gemm prefill {pname}", x_q, w8)
        del x_q, w8
        torch.cuda.empty_cache()
    rows["w8a8_gemm"]["prefill"] = add_rows(pre)

    # Rows 16 and 17 at groups of 256 and 512 (FF_BENCH_GROUP; a group then
    # spans several 128-k stages): the four projections (bf16) and the f32
    # lm_head at M = 192, row 16 bit-equal, row 17 within W4_GEMV_RTOL; the
    # device time of the four projections logged beside g128's
    t0, M = time.perf_counter(), BATCH
    for gb in (256, 512):
        dev_ms = {"w4a8_gemv_halves": [], "w4_gemv": []}
        for pname, (K, N) in shapes.items():
            head = pname == "lm_head"
            out_dtype = torch.float32 if head else torch.bfloat16
            x = act(M, K)
            x_q, x_s = mm.quantize_rowwise(x)
            w = randint(-128, 128, (K // 2, N))
            s = torch.rand((K // gb, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
            for name, kern, plain, check in (
                    ("w4a8_gemv_halves", lambda: mm.matmul_w4a8_gemv(x_q, x_s, w, s, gb, out_dtype),
                     lambda: mm.matmul_w4a8_reference(x_q, x_s, w, s, None, gb, out_dtype),
                     bit_equal),
                    ("w4_gemv", lambda: mm.matmul_w4_gemv(x, w, s, gb, out_dtype),
                     lambda: mm.matmul_w4_gemv_reference(x, w, s, gb, out_dtype), w4_close)):
                ok, err = check(kern(), plain())
                if not ok:
                    raise AssertionError(f"{name} {pname} g{gb}: kernel disagrees with its plain "
                                         f"version (err {err:.3g})")
                if not head:
                    dev_ms[name].append(device_ms(kern))
            del w, s
        got = [None if None in v else sum(v) for v in dev_ms.values()]
        g128 = [rows[k]["device_ms"] for k in dev_ms]
        log(f"w4a8_gemv_halves, w4_gemv g{gb} M={M}: bit-equal and within {W4_GEMV_RTOL} on the "
            f"four projections and the f32 lm_head; device time of the four projections "
            f"{fmt_ms(got[0])} and {fmt_ms(got[1])} (g128: {fmt_ms(g128[0])}, {fmt_ms(g128[1])})")
    torch.cuda.empty_cache()
    log(f"rows 16 and 17 at g256 and g512: {time.perf_counter() - t0:.1f} s")
    return rows


def _by_columns(plain, N, rows, groups, budget=1 << 29):
    """``plain(cols)`` (a plain version on the weight's columns ``cols``)
    over every column in chunks whose (rows, cols, groups) f32 group
    products stay within ``budget`` elements (the W4A8 oracle stacks them
    before its window sum), concatenated: the same bits as one call, each
    output column depending on its own weight column only."""
    step = max(128, budget // max(1, rows * groups) // 128 * 128)
    return torch.cat([plain(slice(c, min(N, c + step))) for c in range(0, N, step)], 1)


def _float_scale_group_kernels(dev, gen, randint):
    """Rows 16, 17 and 18t at groups their kernels read x for permuted into
    byte-row order (`float_scale_route` "permuted": one permute pass, then
    the tensor-core kernel, counted once under the row's name), row 16
    bit-equal, 17 and 18t within W4_GEMV_RTOL of the largest plain output
    (one bf16 ulp more), 18t's bias epilogue exact: the four projections
    and the f32 lm_head at g 16, M = 1, 8, 17, 192 and 256; down_proj at
    g 112 (M = 8, 192) and at g 8 (1,792 groups: the window tree; M = 8,
    192); K = g = 192 and 320 (M = 8, 192, both outputs); g 2 at K = 64 and
    4,096 (2,048 groups); row 16 at K = g = 2^17 (int64 group dots, M = 8),
    at g 2 beyond 32^4 groups (the tree's fifth level) and at g = 2^16 + 2
    with 257 and 1,025 groups (int64 dots under every fold).
    IGMMA in the SASS of row 16's permuted kernel. Timed: down_proj at g 112
    and g 128 (M = 192) and the four projections at g 16 (M = 192, the JSON
    rows w4a8_gemv_halves_g16, w4_gemv_g16, w4a16_gemm_g16), against their
    bounds (the scales' bytes counted) and libraries (`_int_mm_yardstick`
    on the unpacked weight; torch.matmul on the dequantized one)."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import launch_counts
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import unpack_int4

    _require_sass(_build._lib_path("w4a8_halves"), "w4a8_perm_kernel", "IGMMA", forbid="IMMA")
    t0, rows, calls = time.perf_counter(), {}, 0
    names = ("w4a8_gemv_halves", "w4_gemv", "w4a16_gemm")
    tiled_check = functools.partial(w4_close, record=W4A16_TILED_REL_ERR)

    def weights(K, N, g):
        w = randint(-128, 128, (K // 2, N))
        s = torch.rand((K // g, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
        return w, s

    def check(what, M, K, N, g, w, s, out_dtypes, rows_16_only=False, bias=False):
        """Each row once a dtype at (M, K, N, g) against its plain version
        (column chunks), its count one a call."""
        nonlocal calls
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        x_q, x_s = mm.quantize_rowwise(x)
        for out_dtype in out_dtypes:
            before = {n: launch_counts[n] for n in names}
            got = [("w4a8_gemv_halves", mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, out_dtype),
                    _by_columns(lambda c: mm.matmul_w4a8_reference(
                        x_q, x_s, w[:, c], s[:, c], None, g, out_dtype), N, M, K // g),
                    bit_equal)]
            if not rows_16_only:
                got.append(("w4_gemv", mm.matmul_w4_gemv(x, w, s, g, out_dtype),
                            mm.matmul_w4_gemv_reference(x, w, s, g, out_dtype), w4_close))
                tiled = mm.matmul_w4a16_tiled(x, w, s, None, g, out_dtype)
                got.append(("w4a16_gemm", tiled, _by_columns(
                    lambda c: mm.matmul_w4a16_tiled_reference(x, w[:, c], s[:, c], None, g,
                                                              out_dtype), N, M, 1),
                    tiled_check))
                if bias:  # the bias epilogue, exactly: round(round(y) + bias)
                    b = torch.randn((N,), generator=gen, device=dev)
                    got.append(("w4a16_gemm bias", mm.matmul_w4a16_tiled(x, w, s, b, g, out_dtype),
                                (tiled.float() + b).to(out_dtype), bit_equal))
            expect = {"w4a8_gemv_halves": 1, "w4_gemv": 0 if rows_16_only else 1,
                      "w4a16_gemm": 0 if rows_16_only else 1 + bias}
            counted = {n: launch_counts[n] - before[n] for n in names}
            if counted != expect:
                raise AssertionError(f"{what} M={M} g={g}: launches {counted} != {expect}")
            for name, out, ref, ok_fn in got:
                calls += 1
                ok, err = ok_fn(out, ref)
                if not ok:
                    raise AssertionError(f"{name} {what} M={M} K={K} N={N} g={g} {out_dtype}: "
                                         f"kernel disagrees with its plain version (err {err:.3g})")
            del got

    # the four projections and the f32 lm_head at g 16
    shapes = dict(PROJ, lm_head=(PROJ["qkv"][0], VOCAB))
    for pname, (K, N) in shapes.items():
        w, s = weights(K, N, 16)
        for M in (1, 8, 17, BATCH, 256):
            check(pname, M, K, N, 16, w, s,
                  (torch.float32,) if pname == "lm_head" else (torch.bfloat16,))
        del w, s
        torch.cuda.empty_cache()
    # down_proj at g 112 and 8 (1,792 groups), K = g = 192 and 320, g 2
    K, N = PROJ["down"]
    for g in (112, 8):
        w, s = weights(K, N, g)
        for M in (8, BATCH):
            check(f"down g{g}", M, K, N, g, w, s, (torch.bfloat16,))
        del w, s
    for K, g, Ms in ((192, 192, (8, BATCH)), (320, 320, (8, BATCH)), (64, 2, (8,)),
                     (4096, 2, (8,))):
        w, s = weights(K, 4096, g)
        for M in Ms:
            check(f"K={K}", M, K, 4096, g, w, s, (torch.bfloat16, torch.float32), bias=True)
        del w, s
    # row 16 at K = g = 2^17: each stage's int32 partial widened into int64
    w, s = weights(1 << 17, 4096, 1 << 17)
    check("K = g = 2^17", 8, 1 << 17, 4096, 1 << 17, w, s, (torch.bfloat16, torch.float32),
          rows_16_only=True)
    del w, s
    torch.cuda.empty_cache()
    # row 16 at the group counts only a deeper fold reaches: g 2 beyond 32^4
    # groups (the window tree's fifth level), and g = 2^16 + 2 at 257 groups
    # (int64 dots, every window in one block) and 1,025 (int64 dots, the
    # tree), against the oracle's arithmetic with every group dot in one
    # batched product (`matmul_w4a8_reference` loops over the groups)
    for M, K, N, g in ((8, 2 * (32 ** 4 + 1), 64, 2), (8, 257 * 65538, 16, 65538),
                       (2, 1025 * 65538, 4, 65538)):
        w, s = weights(K, N, g)
        x_q, x_s = mm.quantize_rowwise(
            torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16))
        before = launch_counts["w4a8_gemv_halves"]
        out = mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, torch.float32)
        if launch_counts["w4a8_gemv_halves"] - before != 1:
            raise AssertionError(f"w4a8_gemv_halves K={K} g={g}: not one launch")
        plan = mm.w4a8_plan(M, K, N, g)
        gd = torch.bmm(x_q.double().reshape(M, K // g, g).transpose(0, 1),
                       unpack_int4(w, g).double().reshape(K // g, g, N)).float()
        ref = mm._window_sum((gd * s[:, None, :]).permute(1, 2, 0)) * x_s.float()[:, None]
        del gd, w, s, x_q
        ok, err = bit_equal(out, ref)
        calls += 1
        if not ok:
            raise AssertionError(f"w4a8_gemv_halves M={M} K={K} N={N} g={g} ({plan.fold}): "
                                 f"kernel disagrees with the oracle (err {err:.3g})")
        log(f"w4a8_gemv_halves M={M} K={K} N={N} g={g}: fold {plan.fold}, {plan.n} rows a "
            f"block, bit-equal")
        torch.cuda.empty_cache()
    log(f"permuted route of rows 16, 17, 18t: bit-equal (row 16) and within {W4_GEMV_RTOL} "
        f"(rows 17, 18t; 18t's bias epilogue exact) at g 16 (four projections, f32 lm_head, "
        f"M = 1-256), down_proj g 112 and g 8, K = g = 192 and 320, g 2, row 16 at g = 2^17, "
        f"beyond 32^4 groups and at 257 and 1,025 groups above 2^16 "
        f"({calls} checks, {time.perf_counter() - t0:.1f} s)")

    def timed(label, M, K, N, g):
        """Rows 16, 17 and 18t at one shape: measured rows."""
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        x_q, x_s = mm.quantize_rowwise(x)
        w, s = weights(K, N, g)
        wbytes = K * N // 2 + s.numel() * 4
        out = {"w4a8_gemv_halves": measure(
            "w4a8_gemv_halves", f"{label} M={M} K={K} N={N} g={g} bf16",
            lambda: mm.matmul_w4a8_gemv(x_q, x_s, w, s, g),
            lambda: _by_columns(lambda c: mm.matmul_w4a8_reference(
                x_q, x_s, w[:, c], s[:, c], None, g), N, M, K // g),
            M * K + M * 4 + wbytes + M * N * 2, 2 * M * K * N, INT8_OPS_PER_S, bit_equal,
            plain_n=3)}
        out["w4a8_gemv_halves"]["library_ms"] = _int_mm_yardstick(
            f"w4a8_gemv_halves {label} g{g} (the unpacked int8 weight: no group scales)", x_q,
            unpack_int4(w, g))
        w_bf16 = mm.dequantize_int4_reference(w, s, g)
        out["w4_gemv"] = measure(
            "w4_gemv", f"{label} M={M} K={K} N={N} g={g} bf16",
            lambda: mm.matmul_w4_gemv(x, w, s, g), lambda: mm.matmul_w4_gemv_reference(x, w, s, g),
            M * K * 2 + wbytes + M * N * 2, 2 * M * K * N, BF16_OPS_PER_S, w4_close,
            library=lambda: torch.matmul(x, w_bf16))
        del w_bf16
        v = unpack_int4(w, g).to(torch.bfloat16).reshape(K // g, g, N)
        w_tiled = (v * s.to(torch.bfloat16)[:, None, :]).reshape(K, N)  # 18t's two roundings
        del v
        out["w4a16_gemm"] = measure(
            "w4a16_gemm", f"{label} M={M} K={K} N={N} g={g} bf16",
            lambda: mm.matmul_w4a16_tiled(x, w, s, None, g),
            lambda: mm.matmul_w4a16_tiled_reference(x, w, s, None, g),
            M * K * 2 + wbytes + M * N * 2, 2 * M * K * N, BF16_OPS_PER_S, tiled_check,
            library=lambda: torch.matmul(x, w_tiled), plain_n=3)
        del w_tiled, w, s
        torch.cuda.empty_cache()
        return out

    K, N = PROJ["down"]
    down = {g: timed("down", BATCH, K, N, g) for g in (112, 128)}
    for name in names:
        a, b = down[112][name], down[128][name]
        log(f"{name} down M={BATCH}: g112 device {fmt_ms(a['device_ms'])} ({a['ms']:.4f} ms), "
            f"g128 device {fmt_ms(b['device_ms'])} ({b['ms']:.4f} ms); bound g112 "
            f"{max(a['bytes_ms'], a['ops_ms']):.4f} ms")
        rows[f"{name}_down_g112"] = a
    per = {name: [] for name in names}
    for pname, (K, N) in PROJ.items():
        for name, r in timed(pname, BATCH, K, N, 16).items():
            per[name].append(r)
    for name in names:
        rows[f"{name}_g16"] = total = add_rows(per[name])
        log(f"{name} four projections g16 M={BATCH}: {total['ms']:.4f} ms, device "
            f"{fmt_ms(total['device_ms'])}, bound {max(total['bytes_ms'], total['ops_ms']):.4f} ms "
            f"(bytes {total['bytes_ms']:.4f} ms: packed weights and f32 scales), library "
            f"{fmt_ms(total['library_ms'])}")
    log(f"rows 16, 17, 18t at other groups: the phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return rows


def _two_level_any_kernels(dev, gen, randint):
    """The two-level GEMVs at groups the int8 tensor-core tile does not take
    (`two_level_route` "any": `csrc/w4a8_mma.cuh` w4a8_rows_kernel, byte
    rows in memory order on the int8 tensor cores; run (ag) serves rows 1
    and 9 at g 14). Checked bit-equal against their plain versions: row 1
    (bf16 and f32), rows 5 paired and 9 (flat), row 5's group halves, at
    every group 1-14 each layout takes (K = 64 units, N 260: three column
    tiles, the last ragged) and M = 1, 8, 17, 192; row 4 at g 2 and 6;
    every row at N = 258 (N % 4 != 0: the byte feed); row 9 pre-blocked at
    bn 4 and 6 and flat at g 2 (the old checks' shapes, K 384, N 4,096);
    rows 1, 5 and 9 at K = 14,336 in 1,024 groups of 14, M = 8. Timed at M
    = 192 on Llama-3-8B's down_proj at g 14 (1,024 groups; counts
    a4_gemv_any, w4a8_gemv_any, w4a8_gemv_unpaired_any,
    w4a8_gemv_stacked_any), library torch.matmul of the dequantized
    operands, beside the tile on the same shape at g 16 (rows 1, 5 paired,
    9: logged). The fused heads (W4A8 at g 2, A4 at g 4) and the fused
    tail and its o + gate/up head (g 2) at the 8B widths, M = 8, held to
    the fused routes' policy and timed (counts fused_norm_qkv_any,
    fused_norm_qkv_a4_any, fused_o_mlp_any, fused_o_gu_any), beside the
    tile at g 4 (W4A8) and 8 (A4)."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles

    t0, rows, calls = time.perf_counter(), {}, 0

    def layer(K, N, g, L=1):
        return (randint(-128, 128, (L, K // 2, N)), randint(1, 16, (L, K // g, N)),
                torch.rand((L, N), generator=gen, device=dev) * 1e-3)

    def act(M, K, a4=False):
        x = torch.randn((M, K), generator=gen, device=dev)
        return mm.quantize_rowwise_a4(x) if a4 else mm.quantize_rowwise(x)

    def count(name, fn):
        before = _build.launch_counts[name]
        out = fn()
        if _build.launch_counts[name] != before + 1:
            raise AssertionError(f"{name}: the call did not take the any-group route")
        return out

    def held(name, what, out, ref):
        nonlocal calls
        ok, err = bit_equal(out, ref)
        calls += 1
        if not ok:
            raise AssertionError(f"{name} {what}: err {err}")

    # every group 1-14 of every layout, M = 1, 8, 17, 192, N 260 (and 258:
    # N % 4 != 0), K = 64 units (128 for the smallest units)
    for layout in ("vertical", "paired", "halves"):
        for g in range(1, 15):
            if layout == "halves" and g % 2 or mm.two_level_route(layout, 8 * g, 260, g) == "tile":
                continue
            unit = 2 * g if layout == "paired" else g
            K = unit * (128 if unit < 4 else 64)
            for M, N in ((1, 260), (8, 260), (17, 260), (BATCH, 260), (17, 258)):
                w, mult, s = layer(K, N, g, L=2)
                at = f"g {g} M={M} N={N}"
                if layout == "vertical":
                    x4, x4s = act(M, K, a4=True)
                    mp = pack_mult_nibbles(mult).contiguous()
                    for out_dtype in (torch.bfloat16, torch.float32):
                        out = count("a4_gemv_any", lambda: mm.matmul_w4a4_2l_gemv_stacked(
                            x4, x4s, w, mp, s, 1, group_size=g, out_dtype=out_dtype))
                        held("a4_gemv_any", f"{at} {out_dtype}", out, mm.matmul_w4a4_2l_reference(
                            x4, x4s, w[1], mult[1], s[1], None, g, out_dtype))
                    continue
                paired = layout == "paired"
                name = "w4a8_gemv_any" if paired else "w4a8_gemv_unpaired_any"
                x_q, x_s = act(M, K)
                ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, g,
                                                  torch.float32, paired=paired)
                out = count(name, lambda: mm.matmul_w4a8_2l_gemv(
                    x_q, x_s, w[1], mult[1], s[1], g, torch.float32, paired=paired))
                held(name, at, out, ref)
                if paired:
                    mp = pack_mult_nibbles(mult).contiguous()
                    out = count("w4a8_gemv_stacked_any", lambda: mm.matmul_w4a8_2l_gemv_stacked(
                        x_q, x_s, w, mp, s, 1, group_size=g))
                    held("w4a8_gemv_stacked_any", at, out, ref.to(torch.bfloat16))
                    if g in (2, 6) and M in (8, BATCH):
                        ids = count(name, lambda: mm.matmul_w4a8_2l_gemv_argmax(
                            x_q, x_s, w[1], mult[1], s[1], g, paired=True))
                        calls += 1
                        if not torch.equal(ids, torch.argmax(ref, dim=-1).to(torch.int32)):
                            raise AssertionError(f"the argmax head at {at}: ids differ")
    log(f"two-level any-group routes: bit-equal at every group 1-14 of each layout, M = 1, 8, "
        f"17, 192 (N 260) and N 258 ({calls} checks)")
    # 1,024 groups of 14 along K (down_proj's K), M = 8
    K, N, g = PROJ["down"][0], 516, 14
    w, mult, s = layer(K, N, g)
    mp = pack_mult_nibbles(mult).contiguous()
    x_q, x_s = act(8, K)
    x4, x4s = act(8, K, a4=True)
    held("a4_gemv_any", "K 14336 g 14", count("a4_gemv_any", lambda: mm.matmul_w4a4_2l_gemv_stacked(
        x4, x4s, w, mp, s, 0, group_size=g)), mm.matmul_w4a4_2l_reference(
        x4, x4s, w[0], mult[0], s[0], None, g))
    for paired in (True, False):
        name = "w4a8_gemv_any" if paired else "w4a8_gemv_unpaired_any"
        held(name, "K 14336 g 14", count(name, lambda: mm.matmul_w4a8_2l_gemv(
            x_q, x_s, w[0], mult[0], s[0], g, paired=paired)), mm.matmul_w4a8_2l_reference(
            x_q, x_s, w[0], mult[0], s[0], None, g, paired=paired))
    held("w4a8_gemv_stacked_any", "K 14336 g 14", count(
        "w4a8_gemv_stacked_any", lambda: mm.matmul_w4a8_2l_gemv_stacked(
            x_q, x_s, w, mp, s, 0, group_size=g)), mm.matmul_w4a8_2l_reference(
        x_q, x_s, w[0], mult[0], s[0], None, g, paired=True))
    del w, mult, s, mp
    # the old checks' shapes: N 4096, M 8 and 192; row 9 pre-blocked at bn
    # 4 and 6 (the word and the byte feeds) on N 4,098 and 4,096
    K, N = 384, 4096
    for M in (8, BATCH):
        w, mult, s = layer(K, N, 12)
        mp = pack_mult_nibbles(mult).contiguous()
        x4, x4s = act(M, K, a4=True)
        for out_dtype in (torch.bfloat16, torch.float32):
            out = count("a4_gemv_any", lambda: mm.matmul_w4a4_2l_gemv_stacked(
                x4, x4s, w, mp, s, 0, group_size=12, out_dtype=out_dtype))
            ok, err = bit_equal(out, mm.matmul_w4a4_2l_reference(x4, x4s, w[0], mult[0], s[0],
                                                                 None, 12, out_dtype))
            calls += 1
            if not ok:
                raise AssertionError(f"a4_gemv_any g 12 M={M} {out_dtype}: err {err}")
        x_q, x_s = act(M, K)
        for name, g, paired in (("w4a8_gemv_any", 2, True), ("w4a8_gemv_unpaired_any", 4, False)):
            w, mult, s = layer(K, N, g)
            for out_dtype in (torch.bfloat16, torch.float32):
                out = count(name, lambda: mm.matmul_w4a8_2l_gemv(
                    x_q, x_s, w[0], mult[0], s[0], g, out_dtype, paired=paired))
                ok, err = bit_equal(out, mm.matmul_w4a8_2l_reference(
                    x_q, x_s, w[0], mult[0], s[0], None, g, out_dtype, paired=paired))
                calls += 1
                if not ok:
                    raise AssertionError(f"{name} g {g} M={M} {out_dtype}: err {err}")
        w, mult, s = layer(K, N, 2, L=2)
        mp = pack_mult_nibbles(mult).contiguous()
        ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, 2,
                                          torch.float32, paired=True)
        ids = count("w4a8_gemv_any", lambda: mm.matmul_w4a8_2l_gemv_argmax(
            x_q, x_s, w[1], mult[1], s[1], 2, paired=True))
        calls += 1
        if not torch.equal(ids, torch.argmax(ref, dim=-1).to(torch.int32)):
            raise AssertionError(f"the argmax head at g 2 M={M}: ids differ")
        for wt in (w, mm.preblock_stacked(w, PANEL), mm.preblock_stacked(w, 4)):
            out = count("w4a8_gemv_stacked_any", lambda wt=wt: mm.matmul_w4a8_2l_gemv_stacked(
                x_q, x_s, wt, mp, s, 1, group_size=2))
            held("w4a8_gemv_stacked_any", f"g 2 M={M}", out, ref.to(torch.bfloat16))
        w, mult, s = layer(K, N + 2, 6, L=2)
        mp = pack_mult_nibbles(mult).contiguous()
        out = count("w4a8_gemv_stacked_any", lambda: mm.matmul_w4a8_2l_gemv_stacked(
            x_q, x_s, mm.preblock_stacked(w, 6), mp, s, 1, group_size=6))
        held("w4a8_gemv_stacked_any", f"g 6 bn 6 M={M}", out, mm.matmul_w4a8_2l_reference(
            x_q, x_s, w[1], mult[1], s[1], None, 6, paired=True))
    log(f"two-level any-group routes: bit-equal at g 12 (row 1, bf16 and f32), g 2 (rows 5, 4, "
        f"9 flat and pre-blocked at bn 512 and 4), g 4 (row 5 group halves), g 6 (row 9 at bn "
        f"6), M = 8 and 192; in all {calls} checks")
    # timed: down_proj at g 14, M = 192 (1,024 groups; 512 pairs)
    M, (K, N), g = BATCH, PROJ["down"], 14
    for layout in ("vertical", "paired", "halves"):
        if mm.two_level_route(layout, K, N, g) != "any":
            raise AssertionError(f"g {g} at K {K} is not an any-group shape of {layout}")
    w, mult, s = layer(K, N, g, L=2)
    mp = pack_mult_nibbles(mult).contiguous()
    x_q, x_s = act(M, K)
    x4, x4s = act(M, K, a4=True)
    xb = (x_q.float() * x_s[:, None]).to(torch.bfloat16)
    x4b = (x4.float() * x4s[:, None]).to(torch.bfloat16)
    wbytes = K * N // 2 + (K // g) * N + N * 4
    io = M * K + M * 4 + M * N * 2
    ops = 2 * M * K * N
    s_eff = mult[1].float() * s[1][None, :]
    w_bf16 = mm.dequantize_int4_vertical_reference(w[1], s_eff, g)
    rows["a4_gemv_any"] = measure(
        "a4_gemv_any", f"down M={M} K={K} N={N} g={g}",
        lambda: mm.matmul_w4a4_2l_gemv_stacked(x4, x4s, w, mp, s, 1, group_size=g),
        lambda: mm.matmul_w4a4_2l_reference(x4, x4s, w[1], mult[1], s[1], None, g),
        wbytes - (K // g) * N + mp[1].numel() * 4 + io, ops, INT8_OPS_PER_S, bit_equal,
        library=lambda: torch.matmul(x4b, w_bf16), plain_n=3)
    w_bf16 = mm.dequantize_int4_paired_reference(w[1], s_eff, g)
    rows["w4a8_gemv_any"] = measure(
        "w4a8_gemv_any", f"down M={M} K={K} N={N} g={g} paired",
        lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w[1], mult[1], s[1], g, paired=True),
        lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, g, paired=True),
        wbytes + io, ops, INT8_OPS_PER_S, bit_equal, library=lambda: torch.matmul(xb, w_bf16),
        plain_n=3)
    rows["w4a8_gemv_stacked_any"] = measure(
        "w4a8_gemv_stacked_any", f"down M={M} K={K} N={N} g={g}",
        lambda: mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, w, mp, s, 1, group_size=g),
        lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, g, paired=True),
        wbytes - (K // g) * N + mp[1].numel() * 4 + io, ops, INT8_OPS_PER_S, bit_equal,
        library=lambda: torch.matmul(xb, w_bf16), plain_n=3)
    w_bf16 = mm.dequantize_int4_reference(w[1], s_eff, g, offset_binary=True)
    rows["w4a8_gemv_unpaired_any"] = measure(
        "w4a8_gemv_unpaired_any", f"down M={M} K={K} N={N} g={g} group halves",
        lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w[1], mult[1], s[1], g, paired=False),
        lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, g, paired=False),
        wbytes + io, ops, INT8_OPS_PER_S, bit_equal, library=lambda: torch.matmul(xb, w_bf16),
        plain_n=3)
    del w, mult, s, mp, w_bf16, s_eff
    # the yardstick: the tile on the same shape at g 16 (units of 16 rows)
    w, mult, s = layer(K, N, 16, L=2)
    mp = pack_mult_nibbles(mult).contiguous()
    tile = {"a4_gemv": lambda: mm.matmul_w4a4_2l_gemv_stacked(x4, x4s, w, mp, s, 1, group_size=16),
            "w4a8_gemv": lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w[1], mult[1], s[1], 16,
                                                        paired=True),
            "w4a8_gemv_stacked": lambda: mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, w, mp, s, 1,
                                                                        group_size=16)}
    log(f"two-level tile on down M={M} K={K} N={N} at g 16 (the any-group route's yardstick): "
        + ", ".join(f"{k} device {fmt_ms(device_ms(fn))}" for k, fn in tile.items()))
    del w, mult, s, mp, tile
    torch.cuda.empty_cache()
    rows.update(_fused_any_kernels(dev, gen, randint))
    log(f"two-level any-group routes: the phase {time.perf_counter() - t0:.1f} s")
    return rows


def _fused_any_kernels(dev, gen, randint):
    """The fused heads, tail and o + gate/up head at groups the tile does not
    take, Llama-3-8B widths, M = 8, layer 1 of 2 (see
    `_two_level_any_kernels`); held as on the tile (`_fused_route_kernels`,
    `_fused_tail_kernel`): x1 bit-equal, int8 activations one level off in
    at most TAIL_LEVEL_SHARE of the elements, outputs within rtol 8e-3."""
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles, unpack_mult_nibbles

    rows, L, eps, M = {}, 2, 1e-5, 8
    K, N = PROJ["qkv"]
    for name, a4, g, g_tile in (("fused_norm_qkv_any", False, 2, 4),
                                ("fused_norm_qkv_a4_any", True, 4, 8)):
        # the yardstick: the tile at the nearest group it takes
        w, mp = randint(-128, 128, (L, K // 2, N)), pack_mult_nibbles(
            randint(1, 16, (L, K // g_tile, N))).contiguous()
        s_col = torch.rand((L, N), generator=gen, device=dev) * 1e-3
        norm = (torch.rand((L, K), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(torch.bfloat16)
        log(f"{name}: the tile at g {g_tile} on the same shape, device " + fmt_ms(device_ms(
            lambda: mm._fused_head_launch(a4, x, norm, w, mp, s_col, 1, g_tile, eps,
                                          torch.bfloat16))))
        w, mult = randint(-128, 128, (L, K // 2, N)), randint(1, 16, (L, K // g, N))
        mp = pack_mult_nibbles(mult).contiguous()
        s_col = torch.rand((L, N), generator=gen, device=dev) * 1e-3
        norm = (torch.rand((L, K), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        quant = mm.quantize_rowwise_a4 if a4 else mm.quantize_rowwise
        x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(torch.bfloat16)
        diffs = {}

        def plain():
            h_q, h_s = mm._norm_quant(x, norm[1], eps, quant)
            ref = (mm.matmul_w4a4_2l_reference if a4 else mm.matmul_w4a8_2l_reference)(
                h_q, h_s, w[1], mult[1], s_col[1], None, g, torch.float32)
            return ref.to(torch.bfloat16), h_q, h_s

        def check(out, ref, _d=diffs):
            ok = _level_check(_d, "hq", out[1], ref[1])
            ok_y, err = within_rtol(out[0], ref[0])
            return ok and ok_y, err

        rows[name] = measure(
            name, f"M={M} K={K} N={N} g={g}",
            lambda: mm._fused_head_launch(a4, x, norm, w, mp, s_col, 1, g, eps, torch.bfloat16),
            plain, K * N // 2 + mp[1].numel() * 4 + N * 4 + K * 2 + M * K * 2 + M * N * 2,
            2 * M * K * N, INT8_OPS_PER_S, check, plain_n=3)
        log(f"{name}: int{4 if a4 else 8} elements one level off: {diffs['hq'][0]} of "
            f"{diffs['hq'][1]}")
        del w, mult, mp
    H, inter, g = 4096, 14336, 2
    ops, nbytes_w = [], 0
    for Kp, Np in ((H, H), (H, 2 * inter), (inter, H)):
        w = randint(-128, 128, (L, Kp // 2, Np))
        mp = pack_mult_nibbles(randint(1, 16, (L, Kp // g, Np))).contiguous()
        sc = torch.rand((L, Np), generator=gen, device=dev) * (4.0 / Kp)
        ops += [w, mp, sc]
        nbytes_w += Kp * Np // 2 + mp[1].numel() * 4 + Np * 4
    norm = (torch.rand((L, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    attn = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    layer_ops = mm._fused_o_mlp_layer(norm, *ops, 1, g)
    diffs = {}

    def tail_check(out, ref):
        ok = torch.equal(out[1], ref[1]) and _level_check(diffs, "hq", out[2], ref[2]) \
            and _level_check(diffs, "x2", out[4], ref[4])
        ok_y, err = within_rtol(out[0], ref[0])
        return ok and ok_y, err

    rows["fused_o_mlp_any"] = measure(
        "fused_o_mlp_any", f"M={M} H={H} inter={inter} g={g}",
        lambda: mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g, eps),
        lambda: mm._fused_o_mlp_parts(attn.float(), x_res.float(), *layer_ops, group_size=g),
        nbytes_w + H * 2 + M * H * 2 * 3, 2 * M * (H * H + H * 2 * inter + inter * H),
        INT8_OPS_PER_S, tail_check, plain_n=3)
    o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc = ops[:6]

    def ogu_check(out, ref):
        ok = torch.equal(out[0], ref[0]) and _level_check(diffs, "hq_ogu", out[2], ref[2])
        ok_y, err = within_rtol(out[1], ref[1])
        return ok and ok_y, err

    rows["fused_o_gu_any"] = measure(
        "fused_o_gu_any", f"M={M} H={H} gate/up {2 * inter} g={g}",
        lambda: mm._fused_o_gu_launch(attn, x_res, norm, *ops[:6], 1, g, eps),
        lambda: mm._fused_o_gu_parts(
            attn.float(), x_res.float(), norm[1], o_w[1], unpack_mult_nibbles(o_mp[1], H // g),
            o_sc[1], gu_w[1], unpack_mult_nibbles(gu_mp[1], H // g), gu_sc[1], g, eps),
        nbytes_w - (inter * H // 2 + ops[7][1].numel() * 4 + H * 4) + H * 2 + M * H * 2 * 2
        + M * H * 4 + M * 2 * inter * 2, 2 * M * (H * H + H * 2 * inter), INT8_OPS_PER_S,
        ogu_check, plain_n=3)
    log(f"fused tail and o + gate/up at g {g}: x1 bit-equal; int8 elements one level off: "
        + ", ".join(f"{k} {v[0]} of {v[1]}" for k, v in diffs.items()))
    # the yardstick: the tile at g 4 on the same shapes (the multipliers
    # repacked for 4: their values do not move a time)
    ops4 = list(ops)
    for i, (Kp, Np) in enumerate(((H, H), (H, 2 * inter), (inter, H))):
        ops4[3 * i + 1] = pack_mult_nibbles(randint(1, 16, (L, Kp // 4, Np))).contiguous()
    log("fused tail and o + gate/up: the tile at g 4 on the same shapes, device "
        + fmt_ms(device_ms(lambda: mm._fused_o_mlp_launch(attn, x_res, norm, *ops4, 1, 4, eps)))
        + " and " + fmt_ms(device_ms(
            lambda: mm._fused_o_gu_launch(attn, x_res, norm, *ops4[:6], 1, 4, eps))))
    del ops, ops4, layer_ops
    torch.cuda.empty_cache()
    return rows


def _fused_append_kernels(dev, gen, randint):
    """The decode step's fused K/V quantize and append (rows 2, 21 and 23,
    counted under kv_append, kv_append_layer, paged_kv_append) at bench.py's
    decode: B = 192, Hkv 8, D 128; bf16 k contiguous (RoPE's output) and v
    a strided view of a qkv row; layer 1 of 2 of a 512-token slab (starts
    129..160 with a -1 and an S: no write), one layer's slab, and a pool of
    page 256 (a row of -1 page ids and a row past the table: page 0). Each
    bit-equal to quantize_kv and the row's plain append: int8 bytes and f32
    scales. No single PyTorch call quantizes and appends: no library."""
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import paged_attention as pa

    t0, rows = time.perf_counter(), {}
    L, B, Hkv, d, S = 2, BATCH, 8, 128, SLAB
    qkv = (torch.randn((B, 1, 6 * Hkv, d), generator=gen, device=dev) * 3).to(torch.bfloat16)
    k = qkv[:, :, 4 * Hkv:5 * Hkv].transpose(1, 2).contiguous()
    v = qkv[:, :, 5 * Hkv:].transpose(1, 2)
    starts = torch.randint(PROMPT, PROMPT + STEPS, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    starts[2], starts[3] = -1, S
    new_bytes = 2 * B * Hkv * d * 2 + 2 * B * Hkv * (d + 4) + B * 4
    ops = 5 * 2 * B * Hkv * d  # |x|, max, divide, round, clamp an element

    def append_check(out, ref):
        return all(torch.equal(a, r) for a, r in zip(out, ref)), \
            max(max_err(a, r) for a, r in zip(out, ref))

    slab = [randint(-128, 128, (L, B, Hkv, S, d)) for _ in range(2)]
    slab += [torch.rand((L, B, Hkv, S), generator=gen, device=dev) for _ in range(2)]
    bufs, ref_bufs = [t.clone() for t in slab], [t.clone() for t in slab]
    rows["kv_quantize_append"] = measure(
        "kv_quantize_append", f"B={B} Hkv={Hkv} d={d} S={S} (starts -1 and S, v strided)",
        lambda: kvu.kv_quantize_append_stacked(*bufs, k, v, starts, 1),
        lambda: kvu.kv_quantize_append_stacked_reference(*ref_bufs, k, v, starts, 1),
        new_bytes, ops, F32_OPS_PER_S, append_check)

    def unfused():  # the route it replaces: quantize_kv of k and v, then the int8 append
        (kq, ksn), (vq, vsn) = kvu.quantize_kv(k), kvu.quantize_kv(v)
        kvu.kv_append_decode_int8_stacked(*bufs, kq.contiguous(), vq.contiguous(),
                                          ksn.contiguous(), vsn.contiguous(), starts, 1)
    log(f"kv_quantize_append: the unfused route it replaces (quantize_kv x 2 + the int8 "
        f"append, {launches_per_call(unfused)} launches) {median_ms(unfused):.4f} ms, device "
        f"{fmt_ms(device_ms(unfused))}")
    layer = [t[1] for t in slab]
    bufs, ref_bufs = [t.clone() for t in layer], [t.clone() for t in layer]
    rows["kv_quantize_append_layer"] = measure(
        "kv_quantize_append_layer", f"B={B} Hkv={Hkv} d={d} S={S} (starts -1 and S, v strided)",
        lambda: kvu.kv_quantize_append(*bufs, k, v, starts),
        lambda: kvu.kv_quantize_append_reference(*ref_bufs, k, v, starts),
        new_bytes, ops, F32_OPS_PER_S, append_check)
    del slab, layer, bufs, ref_bufs
    page, MP = ENGINE_PAGE, 2
    P = B + 9
    pools = [randint(-128, 128, (L, P, Hkv, page, d)) for _ in range(2)]
    pools += [torch.rand((L, P, Hkv, page), generator=gen, device=dev) for _ in range(2)]
    table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
    table[:, 0] = (torch.randperm(P - 1, generator=gen, device=dev)[:B] + 1).to(torch.int32)
    pos = (starts % page).clone()
    pos[2], table[2] = 7, -1          # a retired slot: its -1 page id is page 0
    pos[3] = MP * page + 9            # past the table: page 0, another row
    bufs, ref_bufs = [t.clone() for t in pools], [t.clone() for t in pools]
    rows["paged_kv_quantize_append"] = measure(
        "paged_kv_quantize_append",
        f"B={B} P={P} page={page} Hkv={Hkv} d={d} (a -1 row, a row past the table, v strided)",
        lambda: pa.paged_kv_quantize_append(*bufs, k, v, pos, table, 1),
        lambda: pa.paged_kv_quantize_append_reference(*ref_bufs, k, v, pos, table, 1),
        new_bytes + B * MP * 4, ops, F32_OPS_PER_S, append_check)
    del pools, bufs, ref_bufs
    torch.cuda.empty_cache()
    log(f"fused K/V quantize and append, three forms: {time.perf_counter() - t0:.1f} s")
    return rows


def _layer_kernels(dev, gen, randint):
    """The per-layer cache path's kernels at bench.py's shapes: the
    unpaired two-level W4A8 GEMV over the seven projections of a layer at
    M = 192 (the JSON row) and the lm_head (f32 logits); the per-layer
    append and flash decode at B = 192, lengths 129..160 (Hkv 8, G 4, S
    512); flash prefill over bf16 K/V at B = 192, T = 128, starts 0."""
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import matmul as mm

    g, M = 128, BATCH
    rows, per = {}, []
    for pname, (K, N) in dict(LAYER_PROJ, lm_head=(4096, VOCAB)).items():
        head = pname == "lm_head"
        out_dtype = torch.float32 if head else torch.bfloat16
        w = randint(-128, 128, (K // 2, N))
        mult = randint(1, 16, (K // g, N))
        s_col = torch.rand((N,), generator=gen, device=dev) * 1e-3
        x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
        xb = (x_q.float() * x_s[:, None]).to(torch.bfloat16)
        w_bf16 = mm.dequantize_int4_reference(w, mult.float() * s_col[None, :], g,
                                              offset_binary=True)
        r = measure(
            "w4a8_gemv_unpaired", f"{pname} M={M} K={K} N={N} g={g} {out_dtype}",
            lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, mult, s_col, g, out_dtype, paired=False),
            lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, g, out_dtype,
                                                paired=False),
            M * K + M * 4 + K * N // 2 + (K // g) * N + N * 4 + M * N * (4 if head else 2),
            2 * M * K * N, INT8_OPS_PER_S, bit_equal,
            library=lambda: torch.matmul(xb, w_bf16), plain_n=5 if head else 20)
        if not head:
            per.append(r)
        del w, mult, w_bf16
    rows["w4a8_gemv_unpaired"] = add_rows(per)

    Hkv, G, d, S, B = 8, 4, 128, SLAB, BATCH
    H = Hkv * G
    kc, vc = randint(-128, 128, (B, Hkv, S, d)), randint(-128, 128, (B, Hkv, S, d))
    ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    new = [randint(-128, 128, (B, Hkv, 1, d)) for _ in range(2)]
    new += [torch.rand((B, Hkv, 1), generator=gen, device=dev) for _ in range(2)]
    lo, hi = PROMPT + 1, PROMPT + STEPS + 1
    lengths = torch.randint(lo, hi, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = lo, hi - 1
    starts = (lengths - 1).contiguous()
    bufs = [t.clone() for t in (kc, vc, ks, vs)]

    def append_check(out, ref):
        return all(torch.equal(a, r) for a, r in zip(out, ref)), \
            max(max_err(a, r) for a, r in zip(out, ref))

    rows["kv_append_layer"] = measure(
        "kv_append_layer", f"B={B} Hkv={Hkv} d={d} S={S}",
        lambda: kvu.kv_append_decode_int8(*bufs, *new, starts),
        lambda: kvu.kv_append_decode_reference(kc, vc, ks, vs, *new, starts),
        2 * 2 * B * Hkv * (d + 4) + B * 4, 0, INT8_OPS_PER_S, append_check)
    del bufs
    q = torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
    live = int(lengths.sum().item())
    kd = (kc.float() * ks[..., None]).to(torch.bfloat16)
    vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
    amask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    rows["flash_decode_layer"] = measure(
        "flash_decode_layer", f"B={B} H={H} Hkv={Hkv} d={d} S={S} lengths {lo}..{hi - 1}",
        lambda: att.flash_decode_int8(q, kc, ks, vc, vs, lengths),
        lambda: att.flash_decode_int8_reference(q, kc, ks, vc, vs, lengths),
        live * Hkv * 2 * (d + 4) + 2 * B * H * d * 2 + B * 4, 4 * live * G * d * Hkv,
        F32_OPS_PER_S, within_rtol,
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=amask, enable_gqa=True))
    del kc, vc, kd, vd

    T = PROMPT
    k = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((B, H, T, d), generator=gen, device=dev).to(torch.bfloat16)
    starts = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos = torch.arange(T, device=dev)
    cmask = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[None, None]
    # the ragged chunk over a bf16 cache (B 16, T 77, starts 0..300): held,
    # not a JSON row
    kr = torch.randn((16, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
    vr = torch.randn((16, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
    qr = torch.randn((16, H, 77, d), generator=gen, device=dev).to(torch.bfloat16)
    sr = torch.randint(0, 301, (16,), generator=gen, device=dev, dtype=torch.int32)
    pos = sr[:, None].long() + torch.arange(77, device=dev)[None, :]
    live = int(torch.clamp(sr.long() + 77, max=S).sum())
    measure("flash_prefill_bf16", f"B=16 H={H} Hkv={Hkv} T=77 S={S} starts 0..300",
            lambda: att.flash_prefill(qr, kr, None, vr, None, sr),
            lambda: att.flash_prefill_reference(qr, kr, None, vr, None, sr),
            2 * 16 * H * 77 * d * 2 + live * Hkv * 2 * d * 2,
            4 * H * d * int(torch.clamp(pos + 1, max=S).sum()), BF16_OPS_PER_S, within_rtol)
    del kr, vr, qr
    rows["flash_prefill_bf16"] = measure(
        "flash_prefill_bf16", f"B={B} H={H} Hkv={Hkv} T={T} S={S} starts 0",
        lambda: att.flash_prefill(q, k, None, v, None, starts),
        lambda: att.flash_prefill_reference(q, k, None, v, None, starts),
        2 * B * H * T * d * 2 + B * T * Hkv * 2 * d * 2 + B * 4,
        4 * H * d * B * T * (T + 1) // 2, BF16_OPS_PER_S, within_rtol,
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=cmask, enable_gqa=True))
    return rows


def _kernel_name(key):
    """The kernel's name and template arguments in a profiler key."""
    import re

    m = re.search(r"\w+_kernel(<[^>]*>)?", key)
    return m.group(0) if m else key[:40]


def _level_check(diffs, name, a, b):
    """Int8 (or int4) activations ``a`` of a kernel against ``b`` of its
    plain version: within one level in at most TAIL_LEVEL_SHARE of the
    elements; records (elements off, total) in ``diffs[name]``."""
    d = (a.int() - b.int()).abs()
    diffs[name] = (int(d.count_nonzero().item()), a.numel())
    return d.max().item() <= 1 and diffs[name][0] <= TAIL_LEVEL_SHARE * a.numel()


def _fused_route_kernels(dev, gen, randint):
    """The kernels of the flag-gated fused decode routes at the 8B widths,
    M = 192 (the JSON rows, bench.py's decode), 64 and 8, layer 1 of 2: the
    fused W4A8 layer head (g128) and A4 layer head (g512; both products
    the int8 tensor-core tile, IMMA in its SASS or the phase fails), K = 4096,
    N = 6144; the fused o + gate/up head of the tail, K1 = H = 4096, gate/up
    2 x 14336, g128. Held to the fused tail's policy (x1 bit-equal, the
    activations one level off in at most TAIL_LEVEL_SHARE of the elements,
    the outputs within rtol 8e-3); whether the heads' activations and
    outputs came out bit-equal is logged. Library: for the heads, one
    `torch.matmul` of the dequantized activations and weight (the product
    alone); none for o + gate/up (two products), whose device time is
    logged by kernel beside its unfused route's (two stacked GEMVs on the
    tile and torch glue)."""
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles, unpack_mult_nibbles
    from fastforward_tpu_torch.serving.engine import _rms_norm

    # both heads' products are the tensor-core tile (the template's first
    # argument: 0 the A4 head's vertical layout, 1 the W4A8 head's paired one)
    for layout in (0, 1):
        _require_sass(_build._lib_path("fused_head"), f"w4a8_mma_kernelILi{layout}E", "IMMA")
    L, eps = 2, 1e-5
    K, N = PROJ["qkv"]
    rows = {}
    for name, a4, g in (("fused_norm_qkv", False, 128), ("fused_norm_qkv_a4", True, 512)):
        w = randint(-128, 128, (L, K // 2, N))
        mult = randint(1, 16, (L, K // g, N))
        mp = pack_mult_nibbles(mult).contiguous()
        s_col = torch.rand((L, N), generator=gen, device=dev) * 1e-3
        norm = (torch.rand((L, K), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        quant = mm.quantize_rowwise_a4 if a4 else mm.quantize_rowwise
        if a4:
            w_bf16 = mm.dequantize_int4_vertical_reference(w[1], mult[1].float() * s_col[1][None, :], g)
        else:
            w_bf16 = mm.dequantize_int4_paired_reference(w[1], mult[1].float() * s_col[1][None, :], g)
        for M in (BATCH, 64, 8):
            x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(torch.bfloat16)
            diffs, exact = {}, {}

            def plain(x=x):
                h_q, h_s = mm._norm_quant(x, norm[1], eps, quant)
                ref = (mm.matmul_w4a4_2l_reference if a4 else mm.matmul_w4a8_2l_reference)(
                    h_q, h_s, w[1], mult[1], s_col[1], None, g, torch.float32)
                return ref.to(torch.bfloat16), h_q, h_s

            def check(out, ref, _d=diffs, _e=exact):
                _e["bit-equal"] = all(torch.equal(a, b) for a, b in zip(out, ref))
                ok = _level_check(_d, "hq", out[1], ref[1])
                ok_y, err = within_rtol(out[0], ref[0])
                return ok and ok_y, err

            h_q, h_s = quant(x.float())
            xb = (h_q.float() * h_s[:, None]).to(torch.bfloat16)
            r = measure(
                name, f"M={M} K={K} N={N} g={g}",
                lambda x=x: mm._fused_head_launch(a4, x, norm, w, mp, s_col, 1, g, eps,
                                                  torch.bfloat16),
                plain, K * N // 2 + mp[1].numel() * 4 + N * 4 + K * 2 + M * K * 2 + M * N * 2,
                2 * M * K * N, INT8_OPS_PER_S, check,
                library=lambda xb=xb: torch.matmul(xb, w_bf16))
            log(f"{name} M={M}: activations and output "
                f"{'bit-equal' if exact['bit-equal'] else 'not bit-equal'} to the plain version; "
                f"int{4 if a4 else 8} elements one level off: {diffs['hq'][0]} of {diffs['hq'][1]}; "
                "library: torch.matmul of the dequantized operands (the product alone)")
            _log_by_kernel(f"{name} M={M}", lambda x=x: mm._fused_head_launch(
                a4, x, norm, w, mp, s_col, 1, g, eps, torch.bfloat16))
            if M == BATCH:
                rows[name] = r
        del w, mult, mp, w_bf16

    H, inter, g = 4096, 14336, 128
    ops, nbytes_w = [], 0
    for Kp, Np in ((H, H), (H, 2 * inter)):
        w = randint(-128, 128, (L, Kp // 2, Np))
        mp = pack_mult_nibbles(randint(1, 16, (L, Kp // g, Np))).contiguous()
        sc = torch.rand((L, Np), generator=gen, device=dev) * (4.0 / Kp)
        ops += [w, mp, sc]
        nbytes_w += Kp * Np // 2 + mp[1].numel() * 4 + Np * 4
    norm = (torch.rand((L, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc = ops
    layer_ops = (norm[1], o_w[1], unpack_mult_nibbles(o_mp[1], H // g), o_sc[1], gu_w[1],
                 unpack_mult_nibbles(gu_mp[1], H // g), gu_sc[1])
    for M in (BATCH, 64, 8):
        attn = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        diffs = {}

        def check(out, ref, _d=diffs):
            ok = torch.equal(out[0], ref[0]) and _level_check(_d, "hq", out[2], ref[2])
            ok_y, err = within_rtol(out[1], ref[1])
            return ok and ok_y, err

        def kern(attn=attn, x_res=x_res):
            return mm._fused_o_gu_launch(attn, x_res, norm, *ops, 1, g, eps)

        def unfused(attn=attn, x_res=x_res):
            x = x_res + mm.matmul_w4a8_2l_gemv_stacked(*mm.quantize_rowwise(attn), o_w, o_mp, o_sc,
                                                       1, group_size=g)
            return x, mm.matmul_w4a8_2l_gemv_stacked(
                *mm.quantize_rowwise(_rms_norm(x, norm[1], eps)), gu_w, gu_mp, gu_sc, 1,
                group_size=g)

        r = measure(
            "fused_o_gu", f"M={M} H={H} gate/up {2 * inter} g={g}", kern,
            lambda attn=attn, x_res=x_res: mm._fused_o_gu_parts(attn.float(), x_res.float(),
                                                                *layer_ops, g, eps),
            nbytes_w + H * 2 + M * H * 2 * 2 + M * H * 4 + M * 2 * inter * 2,
            2 * M * (H * H + H * 2 * inter), INT8_OPS_PER_S, check)
        r["unfused_ms"], r["unfused_device_ms"] = median_ms(unfused), device_ms(unfused)
        log(f"fused_o_gu M={M}: x1 bit-equal; int8 elements one level off: "
            f"{diffs['hq'][0]} of {diffs['hq'][1]}; unfused route (2 stacked GEMVs on the tile + "
            f"torch glue) {r['unfused_ms']:.4f} ms, device {fmt_ms(r['unfused_device_ms'])}")
        _log_by_kernel(f"fused_o_gu M={M}", kern)
        if M == BATCH:
            rows["fused_o_gu"] = r
    return rows


def _plain_versions():
    """(patch target, plain version, check) of every kernel wrapper the
    serving path calls, under the name that `engine`/`stacked` import."""
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels import paged_attention as pa
    from fastforward_tpu_torch.kernels.packing import unpack_mult_nibbles

    def a4(x_q, x_s, w, mp, s_col, layer, group_size, out_dtype=torch.bfloat16):
        n_groups = x_q.shape[1] // group_size
        return mm.matmul_w4a4_2l_reference(
            x_q, x_s, w[layer], unpack_mult_nibbles(mp[layer], n_groups), s_col[layer], None,
            group_size, out_dtype)

    def w4a8_stacked(x_q, x_s, w, mp, s_col, layer, group_size, out_dtype=torch.bfloat16):
        n_groups = x_q.shape[1] // group_size  # w flat or pre-blocked: every route's function
        return mm.matmul_w4a8_2l_reference(
            x_q, x_s, mm.flat_layer(w, layer), unpack_mult_nibbles(mp[layer], n_groups),
            s_col[layer], None, group_size, out_dtype, paired=True)

    def w4a8(x_q, x_s, w, mult, s_col, group_size, out_dtype, paired):
        return mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, group_size,
                                           out_dtype, paired=paired)

    def argmax(x_q, x_s, w, mult, s_col, group_size, paired):
        return torch.argmax(w4a8(x_q, x_s, w, mult, s_col, group_size, torch.float32, paired),
                            dim=-1).to(torch.int32)

    def dequant(reference):
        def plain(w, mult, s_col, layer, group_size):
            return reference(mm.flat_layer(w, layer), mult[layer].float() * s_col[layer][None, :],
                             group_size)
        return plain

    def w4a8_halves(x_q, x_s, w, s, group_size, out_dtype):
        # in column chunks: the oracle stacks every group's products (the
        # f32 lm_head at g 16: 256 groups of 192 x 128,256)
        return _by_columns(lambda c: mm.matmul_w4a8_reference(
            x_q, x_s, w[:, c], s[:, c], None, group_size, out_dtype), w.shape[1], x_q.shape[0],
            x_q.shape[1] // group_size)

    def flash(q, k, ks, v, vs, lengths, layer, count=None):
        return att.flash_decode_int8_reference(q, k[layer], ks[layer], v[layer], vs[layer], lengths)

    def paged_flash(q, k, ks, v, vs, table, lengths, layer):
        return pa.paged_flash_decode_reference(q, k[layer], ks[layer], v[layer], vs[layer], table,
                                               lengths)

    def fused_tail(attn, x_res, norm_w, *weights, group_size, eps):
        *w, layer = weights
        return mm.fused_o_mlp_reference(
            attn.float(), x_res.float(), *mm._fused_o_mlp_layer(norm_w, *w, layer, group_size),
            group_size, eps).to(attn.dtype)

    def head(reference):
        def plain(x, norm_w, w, mp, s_col, layer, group_size, eps):
            return reference(x.float(), norm_w[layer], w[layer],
                             unpack_mult_nibbles(mp[layer], x.shape[1] // group_size),
                             s_col[layer], group_size, eps).to(torch.bfloat16)
        return plain

    def o_gu(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, layer, group_size, eps):
        g = group_size
        return mm.fused_o_gu_reference(
            attn.float(), x_res.float(), norm_w[layer], o_w[layer],
            unpack_mult_nibbles(o_mp[layer], o_w.shape[1] * 2 // g), o_sc[layer], gu_w[layer],
            unpack_mult_nibbles(gu_mp[layer], gu_w.shape[1] * 2 // g), gu_sc[layer], g, eps)

    def o_gu_check(out, ref):
        ok, err = within_rtol(out[1], ref[1])
        return ok and torch.equal(out[0], ref[0]), err

    eng, stk = "fastforward_tpu_torch.serving.engine", "fastforward_tpu_torch.serving.stacked"
    kvc = "fastforward_tpu_torch.serving.kv_cache"
    mmod = "fastforward_tpu_torch.kernels.matmul"  # the names matmul_w4a8 / _w4a16 route to
    return [
        (f"{eng}.matmul_w4a4_2l_gemv_stacked", a4, bit_equal),
        (f"{eng}.matmul_w4a8_2l_gemv_stacked", w4a8_stacked, bit_equal),
        (f"{eng}.matmul_w4a8_2l_gemv", w4a8, bit_equal),
        (f"{eng}.dequantize_int4_vertical_stacked", dequant(mm.dequantize_int4_vertical_reference),
         bit_equal),
        (f"{eng}.dequantize_int4_paired_stacked", dequant(mm.dequantize_int4_paired_reference),
         bit_equal),
        (f"{eng}.dequantize_int4_vertical", mm.dequantize_int4_vertical_reference, bit_equal),
        (f"{eng}.dequantize_int4", mm.dequantize_int4_reference, bit_equal),
        (f"{eng}.matmul_w8a8", mm.matmul_w8a8_reference, bit_equal),
        (f"{mmod}.matmul_w4a8_gemv", w4a8_halves, bit_equal),
        (f"{mmod}.matmul_w4_gemv", mm.matmul_w4_gemv_reference, w4_close),
        (f"{mmod}.dequantize_int4", mm.dequantize_int4_reference, bit_equal),
        (f"{stk}.matmul_w4a8_2l_gemv_argmax", argmax, bit_equal),
        (f"{stk}.kv_quantize_append_stacked", kvu.kv_quantize_append_stacked_reference, None),
        (f"{stk}.flash_decode_int8_stacked", flash, within_rtol),
        (f"{stk}.flash_decode_int8", att.flash_decode_int8_reference, within_rtol),
        (f"{stk}.flash_prefill", att.flash_prefill_reference, within_rtol),
        (f"{stk}.paged_kv_quantize_append", pa.paged_kv_quantize_append_reference, None),
        (f"{stk}.paged_flash_decode_int8", paged_flash, within_rtol),
        (f"{stk}.fused_o_mlp_stacked", fused_tail, within_rtol),
        (f"{stk}.fused_norm_qkv_stacked", head(mm.fused_norm_qkv_reference), within_rtol),
        (f"{stk}.fused_norm_qkv_stacked_a4", head(mm.fused_norm_qkv_a4_reference), within_rtol),
        (f"{stk}.fused_o_gu_stacked", o_gu, o_gu_check),
        (f"{kvc}.kv_quantize_append", kvu.kv_quantize_append_reference, "layer_append"),
    ]


def _plain_patches():
    """Swap every kernel wrapper the serving path calls for its plain
    PyTorch version."""
    return [mock.patch(target, plain) for target, plain, _ in _plain_versions()]


def _checked_patches(checked):
    """Run every kernel wrapper the serving path calls and also its plain
    version on the same inputs; raise where they disagree, count the
    checked calls in ``checked`` and return the kernel's result."""
    import importlib

    patches = []
    for target, plain, check in _plain_versions():
        module, name = target.rsplit(".", 1)
        kernel = getattr(importlib.import_module(module), name)

        def run(*args, _kernel=kernel, _plain=plain, _check=check, _name=name, **kwargs):
            if _check is None:  # a KV append writes in place: the plain version
                layer = args[-1]  # appends to a copy of the layer
                copy = [t[layer:layer + 1].clone() for t in args[:4]]
                out = _kernel(*args, **kwargs)
                ref = _plain(*copy, *args[4:-1], 0)
                ok, err = bit_equal(torch.cat([t[layer:layer + 1].flatten().view(torch.uint8)
                                               for t in out]),
                                    torch.cat([t.flatten().view(torch.uint8) for t in ref]))
            elif _check == "layer_append":  # one layer's cache, in place: the
                copy = [t.clone() for t in args[:4]]  # plain version appends to a copy
                out = _kernel(*args, **kwargs)
                ref = _plain(*copy, *args[4:])
                ok, err = bit_equal(torch.cat([t.flatten().view(torch.uint8) for t in out]),
                                    torch.cat([t.flatten().view(torch.uint8) for t in ref]))
            else:
                out = _kernel(*args, **kwargs)
                ok, err = _check(out, _plain(*args, **kwargs))
            if not ok:
                raise AssertionError(f"{_name} on the serving path: kernel disagrees with its "
                                     f"plain version (err {err})")
            checked[_name] += 1
            return out

        patches.append(mock.patch(target, run))
    return patches


@dataclasses.dataclass
class ServePath:
    """A model on one of the port's two serving paths: the stacked forward
    over ``layers`` on a StackedKVCache (``kv`` None), or the per-layer
    forward on a KVCache, INT8 (``kv`` "int8") or bf16 ("bf16"). Only its
    methods tell the two apart."""

    config: object
    params: object
    layers: object = None
    kv: str = None

    @staticmethod
    def random(config, mode, g, seed, dev, kv=None):
        """Random weights: per layer from `random_serving_params` (``kv``
        given), else stacked from `random_stacked_params`, fused."""
        from fastforward_tpu_torch.serving import (
            fuse_stacked_layers,
            random_serving_params,
            random_stacked_params,
        )

        if kv is not None:
            params = random_serving_params(config, mode=mode, group_size=g, seed=seed, device=dev)
            return ServePath(config, params, kv=kv)
        params, layers = random_stacked_params(config, mode=mode, group_size=g, seed=seed,
                                               device=dev)
        return ServePath(config, params, fuse_stacked_layers(layers))

    def new_cache(self, B, dev, S=SLAB):
        from fastforward_tpu_torch.serving import KVCache, StackedKVCache

        c = self.config
        if self.kv is not None:
            return KVCache.create(c.num_layers, B, S, c.num_kv_heads, c.head_dim,
                                  quantized=self.kv == "int8", device=dev)
        return StackedKVCache.create(c.num_layers, B, S, c.num_kv_heads, c.head_dim, device=dev)

    def forward(self, ids, cache, **kw):
        from fastforward_tpu_torch.serving import serving_forward, serving_forward_stacked

        if self.kv is not None:
            return serving_forward(self.params, self.config, ids, cache, **kw)
        return serving_forward_stacked(self.params, self.layers, self.config, ids, cache=cache,
                                       **kw)

    def greedy_step(self, token, cache):
        """One decode step's greedy tokens (B,) and the cache: the stacked
        path's greedy head, the argmax of the per-layer path's logits."""
        if self.kv is not None:
            logits, cache = self.forward(token, cache)
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
        return self.forward(token, cache, greedy_head=True)

    def decode(self, cache, token, steps):
        from fastforward_tpu_torch.serving import make_decode_loop, make_stacked_decode_loop

        if self.kv is not None:
            return make_decode_loop(self.config, steps)(self.params, cache, token)
        return make_stacked_decode_loop(self.config, steps)(self.params, self.layers, cache, token)

    @property
    def label(self):
        return "stacked" if self.kv is None else f"per-layer, {self.kv} KVCache"


def _to_pages(slab, config, dev):
    """The prefilled slab rows (S = one page) copied into a pool of the
    engine's size, one page per sequence from a fixed shuffled list."""
    from fastforward_tpu_torch.serving import PagedKVCache
    from fastforward_tpu_torch.serving.paged import scatter_prefill_to_pages

    B = slab.k.shape[1]
    pool = PagedKVCache.create(config.num_layers, ENGINE_PAGES, B, ENGINE_MAXLEN // ENGINE_PAGE,
                               config.num_kv_heads, config.head_dim, page_size=ENGINE_PAGE,
                               device=dev)
    pages = torch.randperm(ENGINE_PAGES - 1, generator=torch.Generator().manual_seed(5))[:B] + 1
    for b, pid in enumerate(pages.tolist()):
        scatter_prefill_to_pages(pool, slab.k, slab.v, slab.k_scale, slab.v_scale, b, [pid])
    pool.table[:, 0] = pages.to(torch.int32).to(dev)
    pool.length = slab.length
    return pool


def _serve(path, ids, steps, dev):
    """Prefill (last-position logits) + ``steps`` greedy tokens on
    ``path``; returns (logits, first token, tokens, cache, prefill ms,
    decode s)."""
    cache = path.new_cache(ids.shape[0], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = path.forward(ids, cache, logits_positions="last")
    first = torch.argmax(logits[:, -1], dim=-1).to(ids.dtype)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens, cache = path.decode(cache, first, steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return logits, first, tokens, cache, (t1 - t0) * 1e3, (t2 - t1)


# substrings of the device names of the port's CUDA kernels
PORT_KERNELS = ("gemv_epilogue_kernel", "argmax_reduce_kernel",
                "kv_append_kernel", "flash_decode_kernel", "dequant_kernel",
                "flash_prefill_kernel", "tail_quant_kernel", "tail_norm_kernel",
                "tail_act_kernel", "tail_out_kernel", "w8a8_wgmma_kernel",
                "w4a8_wgmma_kernel", "w4_gemv_wgmma_kernel", "w4a16_wgmma_kernel",
                "norm_quant_kernel", "w4a8_mma_kernel", "stage_x_kernel",
                "w4a8_perm_kernel", "permute_x_kernel", "w4a8_rows_kernel",
                "stage_rows_kernel", "rows_epilogue_kernel")


def _report_profile(what, wall_ms, rows, top=10):
    busy = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if any(k in r[2] for k in PORT_KERNELS))
    log(f"{what} (profiled): wall {wall_ms:.2f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(r[1] for r in rows):.0f} kernels; port kernels "
        f"{ours:.3f} ms, other kernels {busy - ours:.3f} ms")
    for ms, count, name in rows[:top]:
        log(f"  {ms:9.4f} ms  x{count:6.0f}  {name[:90]}")


def profile_steps(path, cache, token, ids):
    """Profile one decode step (mean of 3, rewriting the last 3 rows of the
    cache) and one prefill (on a fresh cache)."""
    state = {"cache": cache, "token": token}
    cache.length -= 3

    def step():
        tok, state["cache"] = path.greedy_step(state["token"], state["cache"])
        state["token"] = tok.to(token.dtype)[:, None]

    _report_profile("decode step", *_profile(step, 3))
    fresh = path.new_cache(ids.shape[0], ids.device)
    _report_profile("prefill", *_profile(
        lambda: path.forward(ids, fresh, logits_positions="last"), 1))


def serve_run(label, config, mode, g, B, T, steps, dev, expect, kv=None, keep=False,
              record=None, against=None, path=None, gate=True):
    """One main-path run: warm-up, then the measured run with the launch
    counts set to 0 before it and asserted equal to ``expect`` after it.
    ``kv`` "int8" or "bf16": the per-layer forward over a KVCache of that
    kind. ``keep``: also return the path. ``path``: serve these weights
    (an earlier run's) in place of new ones. ``record`` (a dict): filled with
    the run's prefill logits and greedy tokens (on the host), and whether
    its prefill logits were bit-equal to the warm-up's; ``against`` (such a
    dict of another run on the same seed): the tokens must be identical,
    and the prefill logits bit-equal where that run's were stable (with
    ``gate`` False only logged, with the share of equal tokens)."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    if path is None:
        path = ServePath.random(config, mode, g, 0, dev, kv)
        torch.cuda.synchronize()
        log(f"serve {label}: Llama-3-8B {mode} g{g} ({path.label}), {config.num_layers} layers, "
            f"weights on the card in {time.perf_counter() - t0:.1f} s")
    else:
        log(f"serve {label}: Llama-3-8B {mode} g{g} ({path.label}), {config.num_layers} layers, "
            "an earlier run's weights")
    ids = torch.randint(0, config.vocab_size, (B, T), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    warm = _serve(path, ids, 2, dev)[0]  # warm-up: no first-call costs below
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    logits, first, tokens, cache, prefill_ms, decode_s = _serve(path, ids, steps, dev)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    stable = torch.equal(warm, logits)
    log(f"serve {label}: prefill logits {'bit-equal' if stable else 'NOT bit-equal'} to the "
        f"warm-up's (max diff {max_err(warm, logits):.3g})")
    del warm
    if record is not None:
        record.update(logits=logits.cpu(), tokens=tokens.cpu(), stable=stable)
    same = None
    if against is not None:
        same = dict(tokens=torch.equal(tokens.cpu(), against["tokens"]),
                    logits=torch.equal(logits.cpu(), against["logits"]),
                    token_share=(tokens.cpu() == against["tokens"]).float().mean().item(),
                    logits_rel_rms=_rel_rms(logits.cpu().float(), against["logits"].float()))
        log(f"serve {label}: greedy tokens {'identical' if same['tokens'] else 'DIFFER'} "
            f"({same['token_share']:.4f} of {tokens.numel()} equal), prefill logits "
            f"{'bit-equal' if same['logits'] else 'NOT bit-equal'} (relative RMS "
            f"{same['logits_rel_rms']:.4g}) to the reference run's on the same seed")
        if gate and (not same["tokens"] or (against["stable"] and not same["logits"])):
            raise AssertionError(f"{label}: tokens or prefill logits differ from the reference run")
    log(f"serve {label}: prefill {B}x{T} {prefill_ms:.1f} ms; decode {B}x{steps} tokens in "
        f"{decode_s:.3f} s = {B * steps / decode_s:.1f} tok/s; peak memory {peak:.2f} GiB")
    log(f"serve {label}: launches {counts}")
    if counts != expect:
        raise AssertionError(f"{label}: launch counts {counts} != expected {expect}")
    if tuple(logits.shape) != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: prefill logits are not finite (B, 1, vocab)")
    if tuple(tokens.shape) != (B, steps) or not ((tokens >= 0) & (tokens < config.vocab_size)).all():
        raise AssertionError(f"{label}: decoded tokens out of range: {tokens.shape}")
    if cache.length != T + steps:
        raise AssertionError(f"{label}: cache length {cache.length} != {T + steps}")
    profile_steps(path, cache, tokens[:, -1:], ids)
    del cache
    if not keep:
        del path
    torch.cuda.empty_cache()
    out = dict(counts=counts, prefill_ms=prefill_ms, tok_s=B * steps / decode_s, peak_gib=peak,
               seconds=time.perf_counter() - t0, prefill_stable=stable)
    if same is not None:
        out["same_as_reference"] = same
    log(f"serve {label}: {out['seconds']:.1f} s with its warm-up and profiles")
    return (out, path) if keep else out


def _margin(logits):
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _rel_rms(a, b):
    """Relative RMS difference ||a - b|| / ||b||."""
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()


def compare_paths(config, mode, g, dev, batch=BATCH, paged=False, kv=None):
    """Kernel path against plain path on the card at full width and depth
    2, ``batch`` prompts of 128 tokens: prefill logits, then one decode
    step from the same token (its logits, and the greedy token). Returns the names of
    the kernels the kernel path launched. ``paged``: ``batch`` prompts
    prefilled into one page each of a slab, copied into a pool of the
    engine's size, and the decode step through the page table. ``kv``
    "int8" or "bf16": the per-layer forward over a KVCache of that kind.

    On the kernel path every kernel call is also held against its plain
    version on the same inputs (bit-equal; flash attention within
    FLASH_RTOL). End to end, the flash kernels' bf16 roundings (one bf16
    ulp on about a third of the attention outputs) move the quantized
    activations of a random model, the 16-level A4 grid most, so the logits
    are held to LOGIT_RMS[mode] and a greedy token may differ only in a row
    whose plain top-2 margin is at most twice that row's logit error.
    """
    t0 = time.perf_counter()
    small = dataclasses.replace(config, num_layers=2)
    path = ServePath.random(small, mode, g, 1, dev, kv)
    ids = torch.randint(0, small.vocab_size, (batch, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(11))
    label = f"{mode}{' paged' if paged else ''}{'' if kv is None else f' per-layer {kv}'}"

    def run(patches, token=None):
        for p in patches:
            p.start()
        try:
            cache = path.new_cache(batch, dev, ENGINE_PAGE if paged else SLAB)
            logits, cache = path.forward(ids, cache, logits_positions="last")
            if paged:
                cache = _to_pages(cache, small, dev)
            if token is None:
                token = torch.argmax(logits[:, -1], dim=-1).to(ids.dtype)[:, None]
            step_logits, _ = path.forward(token, cache)
            step_tok, _ = path.greedy_step(token, cache)  # rewrites the same row
        finally:
            for p in patches:
                p.stop()
        return logits, token, step_logits, step_tok

    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts

    p_logits, p_first, p_step, p_tok = run(_plain_patches())
    checked = collections.Counter()
    reset_launch_counts()
    k_logits, _, k_step, k_tok = run(_checked_patches(checked), p_first)
    launched = set(launch_counts)
    log(f"serve {label} depth 2: kernel calls held against their plain versions on the same "
        f"inputs: {dict(checked)}; kernels launched {sorted(launched)}")
    k_first = torch.argmax(k_logits[:, -1], dim=-1).to(ids.dtype)[:, None]
    for what, k, p, kt, pt in (("prefill", k_logits, p_logits, k_first[:, 0], p_first[:, 0]),
                               ("decode step", k_step, p_step, k_tok, p_tok)):
        k, p = k[:, -1].float(), p[:, -1].float()
        rms, err = _rel_rms(k, p), (k - p).abs().amax(dim=-1)
        margin = torch.topk(p, 2, dim=-1).values
        margin = margin[:, 0] - margin[:, 1]
        differ = (kt.long() != pt.long()).nonzero().flatten().tolist()
        log(f"serve {label} depth 2 kernel vs plain, {what}: logits relative RMS error {rms:.4g} "
            f"(limit {LOGIT_RMS[mode]}), max err {err.max().item():.4g} of "
            f"{p.abs().max().item():.4g}; {len(differ)} of {len(kt)} greedy tokens differ")
        for b in differ:
            log(f"  row {b}: kernel {int(kt[b])} plain {int(pt[b])}, plain top-2 margin "
                f"{margin[b].item():.4g}, row logit error {err[b].item():.4g}")
        if not rms <= LOGIT_RMS[mode]:
            raise AssertionError(f"{label} {what}: logits of the kernel path differ from the plain path")
        wrong = [b for b in differ if margin[b].item() > 2 * err[b].item()]
        if wrong:
            raise AssertionError(f"{label} {what}: greedy tokens differ where the plain margin "
                                 f"exceeds twice the logit error: rows {wrong}")
    del path
    torch.cuda.empty_cache()
    log(f"serve {label} depth 2, batch {batch}: {time.perf_counter() - t0:.1f} s")
    return launched


def per_layer_vs_stacked(path, dev):
    """(h)'s per-layer weights through `stack_serving_layers` and the
    stacked forward on a StackedKVCache, and through the per-layer forward
    on a KVCache, both INT8: 8 prompts of 128 tokens, 32 greedy steps. The
    same kernels read the same bytes, so the greedy tokens must be
    identical."""
    from fastforward_tpu_torch.serving import stack_serving_layers

    config, params = path.config, path.params
    ids = torch.randint(0, config.vocab_size, (8, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(13))
    stacked = ServePath(config, dataclasses.replace(params, layers=()),
                        stack_serving_layers(params))
    a = _serve(path, ids, STEPS, dev)
    b = _serve(stacked, ids, STEPS, dev)
    same_tokens = torch.equal(a[2], b[2])
    same_logits = torch.equal(a[0], b[0])
    log(f"serve (h) per-layer vs stacked, 8x{PROMPT} + {STEPS} steps: greedy tokens "
        f"{'identical' if same_tokens else 'DIFFER'}; prefill logits "
        f"{'bit-equal' if same_logits else f'max diff {max_err(a[0], b[0]):.3g}'}")
    if not same_tokens:
        raise AssertionError("per-layer and stacked forwards give different greedy tokens")
    del stacked
    torch.cuda.empty_cache()
    return dict(identical_tokens=same_tokens, identical_logits=same_logits)


def _flags_label(flags):
    return " ".join(f"{k}={v}" for k, v in flags.items())


def dense_vs_flash(config, dev, kv=None):
    """(ae) at depth 2: w4a8_2l g128 (stacked, or per layer over an INT8
    KVCache with ``kv`` "int8"), 192 prompts of 128 tokens and one decode
    step from the same first tokens, on the flash routes and under each of
    FLAGS_AE: FF_BENCH_FLASH=0 attends the step densely over the
    dequantized cache (and launches no flash decode), FF_FLASH_PREFILL=0
    the prefill (no flash prefill). Each row of the dense logits must lie
    within LOGIT_RMS["w4a8_2l"] (relative error) of the flash route's, but
    for at most AE_ROW_SHARE of the rows; the relative RMS over the batch,
    the rows beyond the limit and the greedy tokens' share of equal ones
    are logged."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    small = dataclasses.replace(config, num_layers=2)
    path = ServePath.random(small, "w4a8_2l", 128, 1, dev, kv)
    ids = torch.randint(0, small.vocab_size, (BATCH, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(11))
    label = "stacked" if kv is None else f"per-layer {kv}"
    token = None

    def run(flags):
        nonlocal token
        with flag_env(**flags):
            reset_launch_counts()
            cache = path.new_cache(BATCH, dev)
            logits, cache = path.forward(ids, cache, logits_positions="last")
            if token is None:
                token = torch.argmax(logits[:, -1], dim=-1).to(ids.dtype)[:, None]
            step, _ = path.forward(token, cache)
            torch.cuda.synchronize()
            return logits[:, -1].float(), step[:, -1].float(), dict(launch_counts)

    flash = run({})
    out = {}
    for flags in FLAGS_AE:
        dense = run(flags)
        gone = ("flash_decode", "flash_decode_layer") if "FF_BENCH_FLASH" in flags else (
            "flash_prefill",)
        if any(dense[2].get(k) for k in gone) or not any(flash[2].get(k) for k in gone):
            raise AssertionError(f"(ae) {label} {_flags_label(flags)}: launches {dense[2]} "
                                 f"(flash routes {flash[2]})")
        res = {}
        for what, i in (("prefill", 0), ("decode step", 1)):
            rms = _rel_rms(dense[i], flash[i])
            row = ((dense[i] - flash[i]).norm(dim=-1) / flash[i].norm(dim=-1)).cpu()
            beyond = (row > LOGIT_RMS["w4a8_2l"]).nonzero().flatten().tolist()
            share = (dense[i].argmax(-1) == flash[i].argmax(-1)).float().mean().item()
            log(f"serve (ae) {label} depth 2, {_flags_label(flags)}, {what}: logits relative RMS "
                f"{rms:.4g} to the flash routes', median row {row.median().item():.4g}, "
                f"{len(beyond)} of {len(row)} rows beyond {LOGIT_RMS['w4a8_2l']} "
                f"({', '.join(f'{b}: {row[b].item():.4g}' for b in beyond) or 'none'}; at most "
                f"{AE_ROW_SHARE:.0%}), greedy tokens {share:.4f} equal")
            if not (row.isfinite().all() and len(beyond) <= AE_ROW_SHARE * len(row)):
                raise AssertionError(f"(ae) {label} {_flags_label(flags)} {what}: dense logits "
                                     f"differ from the flash routes'")
            res[what] = dict(rel_rms=rms, median_row=row.median().item(), rows_beyond=beyond,
                             token_share=share)
        out[_flags_label(flags)] = res
    del path
    torch.cuda.empty_cache()
    log(f"serve (ae) {label} depth 2: {time.perf_counter() - t0:.1f} s")
    return out


def repack_unpaired_in_place(path):
    """A stacked path's weights into the group-halves layout, in place (the
    paired ones freed projection by projection): every two-level W4A8
    projection and the lm_head through `repack_unpaired` (a relabelling of
    the same nibbles, bit-exact), the layers' packed multipliers kept."""
    from fastforward_tpu_torch.serving import repack_unpaired

    for f in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
        ql = getattr(path.layers, f)
        setattr(path.layers, f, dataclasses.replace(repack_unpaired(ql),
                                                    mult_packed=ql.mult_packed))
    path.params.lm_head = repack_unpaired(path.params.lm_head)


def serve_switches(config, dev, path, ref_b):
    """Runs (ad)-(af) on (b)'s weights in this process, each with its flag
    set only around it, and their depth-2 checks. (ad): the slab flow
    (FLAGS_AD: FF_KV_STACKED=0, FF_KV_WRITE=mask and =scatter,
    FF_PREFILL_STACKED=0) must give (b)'s greedy tokens and prefill logits
    bit for bit, its stacked append and flash decode (1,024 each) replaced
    by the per-layer kernels or by plain-torch writes and the per-layer
    flash decode; (ae): the dense attention routes (FLAGS_AE), their tokens'
    share equal to (b)'s logged; (af): (b)'s weights repacked into the
    group-halves layout under FF_2L_PAIRED=0, every decode GEMV on the
    unpaired GEMV (row 5), (b)'s tokens: ``path`` holds them after this."""
    t0 = time.perf_counter()
    L = config.num_layers
    n = L * STEPS
    b = {"dequant_paired": 4 * L, "w4a8_gemv_stacked": 4 * n, "flash_prefill": L,
         "kv_append": n, "flash_decode": n, "w4a8_gemv": 1, "w4a8_gemv_argmax": STEPS}
    slab = {k: v for k, v in b.items() if k not in ("kv_append", "flash_decode")}
    runs = {}
    for key, flags, expect in (
            ("ad_kv0", FLAGS_AD[0], {**slab, "kv_append_layer": n, "flash_decode_layer": n}),
            ("ad_mask", FLAGS_AD[1], {**slab, "flash_decode_layer": n}),
            ("ad_scatter", FLAGS_AD[2], {**slab, "flash_decode_layer": n}),
            ("ad_prefill", FLAGS_AD[3], b),
            ("ae_decode", FLAGS_AE[0], {**slab, "kv_append_layer": n}),
            ("ae_prefill", FLAGS_AE[1], {k: v for k, v in b.items() if k != "flash_prefill"})):
        with flag_env(**flags):
            runs[key] = serve_run(f"({key[:2]}) {_flags_label(flags)}", config, "w4a8_2l", 128,
                                  BATCH, PROMPT, STEPS, dev, expect, against=ref_b, path=path,
                                  gate=key.startswith("ad"))
    # the slab flow's kernel calls against their plain versions at depth 2
    with flag_env(**FLAGS_AD[0]):
        launched = compare_paths(config, "w4a8_2l", 128, dev)
    if launched != set(runs["ad_kv0"]["counts"]):
        raise AssertionError(f"(ad) FF_KV_STACKED=0 at depth 2 launched {sorted(launched)}")
    runs["ae_depth2"] = {"stacked": dense_vs_flash(config, dev),
                         "per_layer": dense_vs_flash(config, dev, kv="int8")}
    log(f"serve (ad), (ae): {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    repack_unpaired_in_place(path)
    torch.cuda.synchronize()
    log(f"serve (af): (b)'s weights repacked unpaired in {time.perf_counter() - t1:.1f} s")
    unpaired = {"dequant_halves": 4 * L, "w4a8_gemv_unpaired": 4 * n + 1 + STEPS,
                "flash_prefill": L, "kv_append": n, "flash_decode": n}
    with flag_env(**FLAGS_AF):
        runs["af"] = serve_run(f"(af) {_flags_label(FLAGS_AF)}", config, "w4a8_2l", 128, BATCH,
                               PROMPT, STEPS, dev, unpaired, against=ref_b, path=path)
        launched = compare_paths(config, "w4a8_2l", 128, dev)
    if launched != set(unpaired):
        raise AssertionError(f"(af) at depth 2 launched {sorted(launched)}")
    torch.cuda.empty_cache()
    log(f"serve (ad)-(af): {time.perf_counter() - t0:.1f} s")
    return runs


def phase_serve(dev):
    from fastforward_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig.llama3_8b()
    L = config.num_layers
    # the two-level lm_head: the prefill's last position through the W4A8
    # GEMV, each decode step through the argmax head
    shared = {"flash_prefill": L, "kv_append": L * STEPS, "flash_decode": L * STEPS,
              "w4a8_gemv": 1, "w4a8_gemv_argmax": STEPS}
    # the float-scale modes: their lm_head (the prefill's last position and
    # each decode step, f32 logits) runs the layers' decode kernel
    attn = {k: v for k, v in shared.items() if k not in ("w4a8_gemv", "w4a8_gemv_argmax")}
    decode = 4 * L * STEPS + 1 + STEPS
    # the per-layer path: seven unfused projections a layer, the lm_head in
    # the layers' mode
    layer_decode = 7 * L * STEPS + 1 + STEPS
    ref_b = {}  # (b)'s prefill logits and tokens: (m), (n), (o) must give them
    runs = {
        "a": serve_run("(a)", config, "w4a4_2l", 512, BATCH, PROMPT, STEPS, dev,
                       {"dequant_vertical": 4 * L, "a4_gemv": 4 * L * STEPS, **shared}),
    }
    runs["b"], path = serve_run(
        "(b)", config, "w4a8_2l", 128, BATCH, PROMPT, STEPS, dev,
        {"dequant_paired": 4 * L, "w4a8_gemv_stacked": 4 * L * STEPS, **shared}, record=ref_b,
        keep=True)
    # (ad)-(af): the serving switches of the slab flow, the dense attention
    # and the unpaired layout on (b)'s weights (repacked in place for (af))
    runs.update(serve_switches(config, dev, path, ref_b))
    del path
    torch.cuda.empty_cache()
    runs.update({
        "c": serve_run("(c)", config, "w4a4_2l", 512, 8, 32, STEPS, dev,
                       {"a4_gemv": 4 * L * (STEPS + 1), **shared}),
        "e": serve_run("(e)", config, "w4a8", 128, BATCH, PROMPT, STEPS, dev,
                       {"dequant_halves": 4 * L, "w4a8_gemv_halves": decode, **attn}),
        "f": serve_run("(f)", config, "w4a16", 128, BATCH, PROMPT, STEPS, dev,
                       {"dequant_halves": 4 * L, "w4_gemv": decode, **attn}),
        "g": serve_run("(g)", config, "w8a8", 128, BATCH, PROMPT, STEPS, dev,
                       {"w8a8_gemm": decode + 4 * L, **attn}),
    })
    runs["h"], path = serve_run(
        "(h)", config, "w4a8", 128, BATCH, PROMPT, STEPS, dev,
        {"dequant_halves": 7 * L, "w4a8_gemv_halves": layer_decode, "flash_prefill": L,
         "kv_append_layer": L * STEPS, "flash_decode_layer": L * STEPS}, kv="int8", keep=True)
    runs["h"]["per_layer_vs_stacked"] = per_layer_vs_stacked(path, dev)
    del path
    torch.cuda.empty_cache()
    runs["i"] = serve_run(
        "(i)", config, "w4a8_2l", 128, BATCH, PROMPT, STEPS, dev,
        {"dequant_halves": 7 * L, "w4a8_gemv_unpaired": layer_decode, "flash_prefill_bf16": L},
        kv="bf16")
    # the flag-gated fused routes (k) and (l), each with its flags set only
    # around its runs
    with flag_env(**FLAGS_K):
        runs["k"] = serve_run(
            "(k)", config, "w4a4_2l", 512, BATCH, PROMPT, STEPS, dev,
            {"dequant_vertical": 4 * L, "fused_norm_qkv_a4": L * STEPS,
             "a4_gemv": 3 * L * STEPS, **shared})
    with flag_env(**FLAGS_L):
        runs["l"] = serve_run(
            "(l)", config, "w4a8_2l", 128, BATCH, PROMPT, STEPS, dev,
            {"dequant_paired": 4 * L, "fused_norm_qkv": L * STEPS, "fused_o_gu": L * STEPS,
             "w4a8_gemv_stacked": L * STEPS, **shared})
    # the rest of the stacked configurations, on (b)'s seed and weights: (m)
    # pre-blocked, (n) pre-blocked through the manual stream, (o) split-W,
    # (p) dot-raw, (q) concat-pairs
    for run, flags, dequant, gemv in (
            ("m", FLAGS_M, "dequant_paired_preblocked", "w4a8_gemv_preblocked"),
            ("n", FLAGS_N, "dequant_paired_preblocked", "w4a8_gemv_manual"),
            ("o", FLAGS_O, "dequant_paired", "w4a8_gemv_splitw"),
            ("p", FLAGS_P, "dequant_paired", "w4a8_gemv_dotraw"),
            ("q", FLAGS_Q, "dequant_paired", "w4a8_gemv_concat")):
        with flag_env(**flags):
            runs[run] = serve_run(f"({run})", config, "w4a8_2l", 128, BATCH, PROMPT, STEPS, dev,
                                  {dequant: 4 * L, gemv: 4 * L * STEPS, **shared}, against=ref_b)
    del ref_b
    # (r): bench.py's baseline tier, sim_w4 g128 (dense bf16 weights
    # quantized and dequantized on every use, torch.matmul): attention
    # through the port's kernels, no projection kernel
    runs["r"] = serve_run("(r)", config, "sim_w4", 128, BATCH, PROMPT, STEPS, dev, dict(attn))
    for mode, g, run, kv, flags in (
            ("w4a4_2l", 512, "a", None, {}), ("w4a8_2l", 128, "b", None, {}),
            ("w4a8", 128, "e", None, {}), ("w4a16", 128, "f", None, {}),
            ("w8a8", 128, "g", None, {}), ("w4a8", 128, "h", "int8", {}),
            ("w4a8_2l", 128, "i", "bf16", {}), ("w4a4_2l", 512, "k", None, FLAGS_K),
            ("w4a8_2l", 128, "l", None, FLAGS_L), ("w4a8_2l", 128, "m", None, FLAGS_M),
            ("w4a8_2l", 128, "n", None, FLAGS_N), ("w4a8_2l", 128, "o", None, FLAGS_O),
            ("w4a8_2l", 128, "p", None, FLAGS_P), ("w4a8_2l", 128, "q", None, FLAGS_Q),
            ("sim_w4", 128, "r", None, {})):
        with flag_env(**flags):
            launched = compare_paths(config, mode, g, dev, kv=kv)
        if launched != set(runs[run]["counts"]):
            raise AssertionError(f"{mode}: the checked run launched {sorted(launched)}, the main "
                                 f"path {sorted(runs[run]['counts'])}")
    # the o + gate/up head at 8 rows, where the fused tail is switched off
    with flag_env(FF_FUSED_LAYER="0", FF_FUSED_OGU="1"):
        launched = compare_paths(config, "w4a8_2l", 128, dev, batch=8)
    if "fused_o_gu" not in launched or "fused_o_mlp" in launched:
        raise AssertionError(f"FF_FUSED_LAYER=0 FF_FUSED_OGU=1 at 8 rows launched {sorted(launched)}")
    # pre-blocked weights at 8 rows: the pre-blocked GEMV, not the fused tail
    # (every fused route needs flat weights)
    with flag_env(**FLAGS_M):
        launched = compare_paths(config, "w4a8_2l", 128, dev, batch=8)
    if "w4a8_gemv_preblocked" not in launched or "fused_o_mlp" in launched:
        raise AssertionError(f"FF_2L_PREBLOCK=1 at 8 rows launched {sorted(launched)}")
    # the float-scale decode GEMVs at g256 (FF_BENCH_GROUP=256: a group spans
    # two 128-k stages), through the same kernels as at g128
    for mode, gemv in (("w4a8", "w4a8_gemv_halves"), ("w4a16", "w4_gemv")):
        launched = compare_paths(config, mode, 256, dev)
        if launched != {"dequant_halves", gemv, "flash_prefill", "kv_append", "flash_decode"}:
            raise AssertionError(f"{mode} g256 launched {sorted(launched)}")
    # (ac): w4a8 and w4a16 at g 16 (FF_BENCH_GROUP=16), bench.py's shape, the
    # lm_head in the layers' mode: every decode GEMV on the permuted route of
    # rows 16 and 17 (x in byte-row order), counted under the rows' names;
    # then the kernel path against the plain path at depth 2
    t0 = time.perf_counter()
    for key, mode, gemv in (("ac8", "w4a8", "w4a8_gemv_halves"), ("ac16", "w4a16", "w4_gemv")):
        runs[key] = serve_run(f"(ac) {mode} g16", config, mode, 16, BATCH, PROMPT, STEPS, dev,
                              {"dequant_halves": 4 * L, gemv: decode, **attn})
        launched = compare_paths(config, mode, 16, dev)
        if launched != {"dequant_halves", gemv, "flash_prefill", "kv_append", "flash_decode"}:
            raise AssertionError(f"{mode} g16 launched {sorted(launched)}")
    log(f"serve (ac): {time.perf_counter() - t0:.1f} s (both modes, depth 32 and the depth-2 "
        f"checks)")
    # (ag): w4a4_2l and w4a8_2l at g 14 (FF_BENCH_GROUP=14), bench.py's
    # shape. The packer's rule gives down_proj (K = 14,336) 1,024 groups of
    # 14, paired in w4a8_2l, and every other projection and the lm_head g =
    # K = 4,096 (one group: group halves in w4a8_2l, on the tile): down_proj
    # runs the any-group route at every layer and step; the unpaired lm_head
    # takes row 5's f32 logits and their argmax. Then depth 2 as above.
    t0 = time.perf_counter()
    head = {"w4a8_gemv_unpaired": 1 + STEPS}
    for key, mode, expect in (
            ("ag4", "w4a4_2l", {"dequant_vertical": 4 * L, "a4_gemv": 3 * L * STEPS,
                                "a4_gemv_any": L * STEPS, **head}),
            ("ag8", "w4a8_2l", {"dequant_halves": 3 * L, "dequant_paired": L,
                                "w4a8_gemv_stacked_any": L * STEPS,
                                "w4a8_gemv_unpaired": 3 * L * STEPS + head["w4a8_gemv_unpaired"]})):
        runs[key] = serve_run(f"(ag) {mode} g14", config, mode, 14, BATCH, PROMPT, STEPS, dev,
                              {**expect, **attn})
        launched = compare_paths(config, mode, 14, dev)
        if launched != set(runs[key]["counts"]):
            raise AssertionError(f"{mode} g14 launched {sorted(launched)}, the main path "
                                 f"{sorted(runs[key]['counts'])}")
    log(f"serve (ag): {time.perf_counter() - t0:.1f} s (both modes, depth 32 and the depth-2 "
        f"checks)")
    return runs


def _engine_trace(vocab_size):
    """bench.py measure_engine's requests: 2 x 32 prompts, lengths drawn
    from (16, 32, 64, 96) with np.random.RandomState(0)."""
    rng = np.random.RandomState(0)
    trace = []
    for _ in range(2 * ENGINE_SLOTS):
        plen = int(rng.choice(ENGINE_PROMPTS))
        trace.append(rng.randint(0, vocab_size, (plen,)).tolist())
    return trace


def engine_run(label, config, params, layers, trace, dev, paged, quantized_cache=True):
    """bench.py's saturated engine trace, one pass: every request queued up
    front, bursts of 8 until all are done. Launch counts set to 0 just
    before and read just after. ``quantized_cache`` False: a bf16 slab,
    whose decode appends by slice assignment and attends densely (no append
    or flash-decode kernel) and whose prefill takes flash prefill's bf16
    form. Returns (engine, tokens per request, launch counts, summary)."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.serving import ContinuousBatchingEngine, EngineStats

    kw = dict(paged=True, page_size=ENGINE_PAGE, num_pages=ENGINE_PAGES) if paged else {}
    eng = ContinuousBatchingEngine(config, params, layers, max_batch=ENGINE_SLOTS,
                                   max_len=ENGINE_MAXLEN, quantized_cache=quantized_cache,
                                   device=dev, **kw)
    for plen in ENGINE_PROMPTS:  # warm-up: one request per prompt length, as bench.py
        eng.submit(list(range(1, plen + 1)), max_new_tokens=ENGINE_BURST)
        eng.run_until_complete(burst=ENGINE_BURST)
    eng.stats = EngineStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=STEPS) for p in trace]
    while eng._pending or eng.num_active:
        eng.step_burst(ENGINE_BURST)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = [eng._done[r].generated for r in rids]
    st = eng.stats
    total = sum(len(t) for t in tokens)
    summary = dict(
        tok_s=total / wall, wall_seconds=wall, peak_gib=peak, occupancy=st.occupancy,
        decode_steps=st.decode_steps, decode_calls=st.decode_calls,
        useful_tokens=st.useful_tokens, overrun_tokens=st.overrun_tokens, prefills=st.prefills,
        prefill_chunks=st.prefill_chunks, admitted=st.admitted,
        preempt_truncated=st.preempt_truncated, preempt_requeued=st.preempt_requeued,
        device_seconds=st.device_seconds, host_fraction=1 - st.device_seconds / wall)
    log(f"engine {label}: {len(trace)} requests, {total} tokens in {wall:.3f} s = "
        f"{total / wall:.1f} tok/s; peak memory {peak:.2f} GiB")
    log(f"engine {label} stats: " + json.dumps({k: v for k, v in summary.items()
                                                if k not in ("tok_s", "peak_gib")}))
    log(f"engine {label}: launches {counts}")
    bad = [i for i, t in enumerate(tokens)
           if len(t) != STEPS or not all(0 <= x < config.vocab_size for x in t)]
    if bad or st.admitted != len(trace):
        raise AssertionError(f"engine {label}: requests {bad[:8]} did not complete in range")
    L = config.num_layers
    decode = ("paged_kv_append", "paged_flash_decode") if paged else ("kv_append", "flash_decode")
    other = ("kv_append", "flash_decode") if paged else ("paged_kv_append", "paged_flash_decode")
    if not quantized_cache:
        decode, other = (), decode + other
    prefill = "flash_prefill" if quantized_cache else "flash_prefill_bf16"
    expect = {**{k: L * st.decode_steps for k in decode + ("fused_o_mlp",)},
              **{k: 0 for k in other}, prefill: L * st.prefills,
              "w4a8_gemv": st.prefills, "w4a8_gemv_argmax": st.decode_steps}
    wrong = {k: (counts.get(k, 0), v) for k, v in expect.items() if counts.get(k, 0) != v}
    allowed = set(expect) | {"w4a8_gemv_stacked", "dequant_paired"}
    if wrong or not set(counts) <= allowed or counts.get("w4a8_gemv_stacked", 0) < L * st.decode_steps:
        raise AssertionError(f"engine {label}: launch counts (got, expected) {wrong}; {counts}")
    return eng, tokens, counts, summary


def profile_burst(eng, trace):
    """Device-busy share of one 8-step decode burst at 32 live slots."""
    for p in trace[:ENGINE_SLOTS]:
        eng.submit(p, max_new_tokens=ENGINE_BURST + 1)
    eng._admit()
    wall, rows = _profile(lambda: eng._run_burst(ENGINE_BURST), 1)
    busy = sum(r[0] for r in rows)
    _report_profile(f"engine decode burst ({ENGINE_BURST} steps)", wall, rows)
    eng.run_until_complete(burst=ENGINE_BURST)
    return dict(step_wall_ms=wall / ENGINE_BURST, step_busy_ms=busy / ENGINE_BURST,
                busy_share=busy / wall)


def phase_engine(dev):
    """The continuous-batching engine on bench.py's engine workload: paged,
    then the same trace on the slab (the same tokens), then the depth-2
    paged decode held against the plain path."""
    from fastforward_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    path = ServePath.random(config, "w4a8_2l", 128, 0, dev)
    params, layers = path.params, path.layers
    del path
    torch.cuda.synchronize()
    log(f"engine: Llama-3-8B w4a8_2l g128, {config.num_layers} layers, weights on the card in "
        f"{time.perf_counter() - t0:.1f} s; {ENGINE_SLOTS} slots, max_len {ENGINE_MAXLEN}, "
        f"{ENGINE_PAGES} pages of {ENGINE_PAGE}")
    trace = _engine_trace(config.vocab_size)
    eng, paged_tokens, counts, paged = engine_run("paged", config, params, layers, trace, dev,
                                                  paged=True)
    paged["burst"] = profile_burst(eng, trace)
    b = paged["burst"]
    log(f"engine paged decode step: wall {b['step_wall_ms']:.2f} ms, device busy "
        f"{b['step_busy_ms']:.3f} ms ({100 * b['busy_share']:.1f}%)")
    del eng
    torch.cuda.empty_cache()
    eng, slab_tokens, slab_counts, slab = engine_run("slab", config, params, layers, trace, dev,
                                                     paged=False)
    slab["burst"] = profile_burst(eng, trace)
    b = slab["burst"]
    log(f"engine slab decode step: wall {b['step_wall_ms']:.2f} ms, device busy "
        f"{b['step_busy_ms']:.3f} ms ({100 * b['busy_share']:.1f}%)")
    del eng
    differ = [i for i, (a, c) in enumerate(zip(paged_tokens, slab_tokens)) if a != c]
    log(f"engine: paged vs slab tokens, {len(trace) - len(differ)} of {len(trace)} requests "
        f"identical")
    if differ:
        raise AssertionError(f"engine: paged and slab tokens differ in requests {differ[:8]}")
    # the bf16 slab (quantized_cache=False): in-vocabulary tokens and its own
    # launch counts (engine_run); held to the JAX engine on the CPU only
    t1 = time.perf_counter()
    eng, bf16_tokens, bf16_counts, bf16 = engine_run("slab bf16", config, params, layers, trace,
                                                     dev, paged=False, quantized_cache=False)
    bf16["burst"] = profile_burst(eng, trace)
    b = bf16["burst"]
    same = sum(a == c for a, c in zip(bf16_tokens, slab_tokens))
    log(f"engine slab bf16 decode step: wall {b['step_wall_ms']:.2f} ms, device busy "
        f"{b['step_busy_ms']:.3f} ms ({100 * b['busy_share']:.1f}%); {same} of {len(trace)} "
        f"requests' tokens equal to the int8 slab's; {time.perf_counter() - t1:.1f} s")
    del eng
    del params, layers
    torch.cuda.empty_cache()
    launched = compare_paths(config, "w4a8_2l", 128, dev, batch=ENGINE_SLOTS, paged=True)
    if launched != set(counts):
        raise AssertionError(f"paged: the checked run launched {sorted(launched)}, the engine "
                             f"{sorted(counts)}")
    return dict(counts=counts, paged=paged, slab=slab, slab_counts=slab_counts, bf16=bf16,
                bf16_counts=bf16_counts)


def phase_loader(dev):
    """(j): a Llama-3-8B-wide, 2-layer bf16 checkpoint in HF layout written
    to a temporary directory, loaded on the card in w8a8 and w4a8; the
    card's quantized q_proj and lm_head held against the plain quantizer on
    the CPU byte for byte; 8 prompts of 32 tokens and 8 greedy steps served
    from it over an INT8 KVCache. Launch counts are read just after the
    serving run."""
    import shutil
    import tempfile

    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving import load_llama
    from fastforward_tpu_torch.serving.loader import (
        load_tensors,
        quantize_int8,
        quantize_pack_int4,
        write_safetensors,
    )

    config = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2)
    h, inter, V = config.hidden_size, config.intermediate_size, config.vocab_size
    nq, nkv = config.num_heads * config.head_dim, config.num_kv_heads * config.head_dim
    shapes = {"model.embed_tokens.weight": (V, h), "model.norm.weight": (h,),
              "lm_head.weight": (V, h)}
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (nq, h), p + "self_attn.k_proj.weight": (nkv, h),
                       p + "self_attn.v_proj.weight": (nkv, h), p + "self_attn.o_proj.weight": (h, nq),
                       p + "mlp.gate_proj.weight": (inter, h), p + "mlp.up_proj.weight": (inter, h),
                       p + "mlp.down_proj.weight": (h, inter), p + "input_layernorm.weight": (h,),
                       p + "post_attention_layernorm.weight": (h,)})
    gen = torch.Generator(device=dev).manual_seed(21)
    tmp = tempfile.mkdtemp(prefix="ff_checkpoint_")
    out = {}
    try:
        t0 = time.perf_counter()
        tensors = {}
        for name, shape in shapes.items():
            t = torch.randn(shape, generator=gen, device=dev)
            tensors[name] = (0.02 * t if len(shape) == 2 else 1 + 0.1 * t).to(torch.bfloat16)
        path = os.path.join(tmp, "model.safetensors")
        write_safetensors(path, tensors)
        del tensors
        nbytes = os.path.getsize(path)
        log(f"loader (j): wrote a {config.num_layers}-layer Llama-3-8B-wide bf16 checkpoint, "
            f"{nbytes / 1e9:.3f} GB, in {time.perf_counter() - t0:.1f} s")
        host = load_tensors(path)
        for mode in ("w8a8", "w4a8"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = load_llama(tmp, config, mode=mode, group_size=128, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            log(f"loader (j) {mode}: loaded and quantized on the card in {load_s:.2f} s = "
                f"{nbytes / load_s / 1e9:.2f} GB/s of checkpoint")
            t0 = time.perf_counter()
            for name, ql in (("model.layers.0.self_attn.q_proj.weight", params.layers[0].q_proj),
                             ("lm_head.weight", params.lm_head)):
                w = host[name].float().t().contiguous()
                data, scale = quantize_int8(w) if mode == "w8a8" else quantize_pack_int4(w, 128)
                if not (torch.equal(ql.data.cpu(), data) and torch.equal(ql.scale.cpu(), scale)):
                    raise AssertionError(f"loader {mode}: {name} quantized on the card differs "
                                         "from the plain quantizer on the CPU")
            log(f"loader (j) {mode}: q_proj and lm_head byte-equal to the plain quantizer on the "
                f"CPU (checked in {time.perf_counter() - t0:.1f} s)")
            ids = torch.randint(0, V, (8, 32), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(23))
            served = ServePath(config, params, kv="int8")
            cache = served.new_cache(8, dev, S=64)
            reset_launch_counts()
            logits, cache = served.forward(ids, cache, logits_positions="last")
            first = torch.argmax(logits[:, -1], dim=-1)[:, None]
            tokens, cache = served.decode(cache, first, 8)
            torch.cuda.synchronize()
            counts = dict(launch_counts)
            log(f"loader (j) {mode}: served 8x32 + 8 greedy steps; launches {counts}")
            L = config.num_layers
            if not torch.isfinite(logits).all() or tuple(tokens.shape) != (8, 8) \
                    or cache.length != 40 or counts.get("flash_prefill") != L \
                    or counts.get("kv_append_layer") != 8 * L \
                    or counts.get("flash_decode_layer") != 8 * L:
                raise AssertionError(f"loader {mode}: the loaded model did not serve as expected")
            out[mode] = dict(load_seconds=load_s, gb_per_s=nbytes / load_s / 1e9, counts=counts)
            del params, served, cache
            torch.cuda.empty_cache()
        del host
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["checkpoint_bytes"] = nbytes
    return out


# Run (s): one MoE block at Mixtral-8x7B's expert widths
# (mistralai/Mixtral-8x7B-v0.1 config.json: hidden_size 4096,
# intermediate_size 14336, num_local_experts 8, num_experts_per_tok 2),
# w4a8_2l g128, at bench.py's decode batch and at 8 tokens; run (u) the same
# block at EP 2.
MOE = dict(hidden=4096, intermediate=14336, num_experts=8, top_k=2)
MOE_SEED, MOE_TOKENS = 21, (BATCH, 8)
# Runs (t) and (u): two processes on the one card over gloo (NCCL refuses
# two ranks on one device); gloo's all_reduce takes CUDA tensors and stages
# them through host memory itself. (t)'s depth-2 logits against the
# one-card path: relative RMS error at most this (each shard quantizes its
# own rows of o_proj's and down_proj's inputs: TP's own numerics).
PARALLEL_RANKS = 2
TP_LOGIT_RMS = 0.1
# Run (v): ring attention at SP 2 on Llama-3-8B's attention widths (32
# heads of 128), causal, bf16, 4,096 tokens (2,048 a rank); run (w): a GPipe
# pipeline at PP 2 of 32 stacked w4a8_2l g128 QuantLinear layers at
# o_proj's 4,096 x 4,096, x (192, 4,096) f32 in 4 microbatches. Both in the
# spawn of (t) and (u), where every ring hop crosses host memory (gloo).
SP_SHAPE = (1, 32, 4096, 128)
PP_LAYERS, PP_WIDTH, PP_MICRO = 32, 4096, 4
# Run (x): the simulation tier's core on gate_proj's (K, N) = (4,096,
# 14,336) in f32, per channel 8-bit and per block (128, 1) 4-bit, dynamic
# per-row on (192, 4,096); then one sim-tier KV append at (h)'s cache shape.
# Scale and offset gradients (per-tile sums in another order on the card)
# within this share of the largest |gradient| of the CPU copy's.
QUANT_SHAPE, QUANT_GRAD_RTOL = (4096, 14336), 1e-6
# Run (y): largest relative RMS of a projection's W8A8 output against the
# dense fallback on the same dequantized weight (the int8 activations)
SIM_RMS = 2e-2


def _moe_inputs(dev):
    """(s)'s block and token rows, the same in every process on the card:
    made from fixed seeds on the device."""
    from fastforward_tpu_torch.serving.moe import make_moe_block

    block = make_moe_block(torch.Generator(device=dev).manual_seed(MOE_SEED), MOE["hidden"],
                           MOE["intermediate"], MOE["num_experts"], "w4a8_2l", 128,
                           MOE["top_k"], device=dev)
    xs = {T: torch.randn((T, MOE["hidden"]), generator=torch.Generator(device=dev).manual_seed(T),
                         device=dev).to(torch.bfloat16) for T in MOE_TOKENS}
    return block, xs


def _checked(fn, checked):
    """``fn()`` with every kernel call held against its plain version."""
    patches = _checked_patches(checked)
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in patches:
            p.stop()


def phase_moe(dev):
    """Run (s): `moe_forward` of one Mixtral-8x7B-wide w4a8_2l block on the
    card: each expert's gate/up and down through row 5 (the W4A8 GEMV on the
    int8 tensor-core tile), 2 launches an expert. Per token count: launches
    asserted exactly, every kernel call held against its plain version
    (bit-equal), wall and device ms a block, device ms by kernel."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.serving.moe import moe_forward

    t0 = time.perf_counter()
    block, xs = _moe_inputs(dev)
    torch.cuda.synchronize()
    packed = sum(t.numel() * t.element_size() for ql in (block.gate_up, block.down)
                 for t in (ql.data, ql.scale, ql.mult))
    log(f"moe (s): Mixtral-8x7B expert widths (hidden {MOE['hidden']}, intermediate "
        f"{MOE['intermediate']}, {MOE['num_experts']} experts, top {MOE['top_k']}), w4a8_2l g128, "
        f"{packed / 1e9:.3f} GB of packed experts, made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for T, x in xs.items():
        fn = functools.partial(moe_forward, x, block)
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        y = fn()
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        expect = {"w4a8_gemv": 2 * MOE["num_experts"]}
        if counts != expect:
            raise AssertionError(f"moe (s) T={T}: launch counts {counts} != expected {expect}")
        checked = collections.Counter()
        if not torch.equal(_checked(fn, checked), y):
            raise AssertionError(f"moe (s) T={T}: the checked call gave other bits")
        ms, dms = median_ms(fn), device_ms(fn)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"moe (s) T={T}: {ms:.4f} ms a block, device {fmt_ms(dms)}; launches {counts}; "
            f"kernel calls held against their plain versions: {dict(checked)}; peak "
            f"{peak:.2f} GiB")
        _log_by_kernel(f"moe (s) T={T}", fn)
        if tuple(y.shape) != (T, MOE["hidden"]) or not torch.isfinite(y.float()).all():
            raise AssertionError(f"moe (s) T={T}: output not finite ({T}, hidden)")
        out[T] = dict(counts=counts, ms=ms, device_ms=dms, peak_gib=peak, checked=dict(checked),
                      y=y.float().cpu())
    del block, xs
    torch.cuda.empty_cache()
    return out


def _tp_run(rank, dev, say):
    """Run (t) on this rank: Llama-3-8B w4a8_2l g128 at tp 2 (heads,
    columns and o/down rows split over the ``model`` dim), prefill of
    bench.py's 192 x 128 through the stacked forward with the TP group, 32
    greedy steps through `make_tp_decode_loop`, one step profiled through
    `make_tp_decode_step`; then at depth 2 every kernel call checked and
    the logits held to the one-card path."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.parallel import (
        make_mesh,
        make_tp_decode_loop,
        make_tp_decode_step,
        shard_for_tp,
    )
    from fastforward_tpu_torch.serving import (
        StackedKVCache,
        random_stacked_params,
        serving_forward_stacked,
    )

    t0 = time.perf_counter()
    config = LlamaConfig.llama3_8b()
    L, tp = config.num_layers, PARALLEL_RANKS
    mesh = make_mesh({"data": 1, "model": tp})
    group = mesh.get_group("model")
    local = dataclasses.replace(config, num_heads=config.num_heads // tp,
                                num_kv_heads=config.num_kv_heads // tp)

    def shard(cfg, seed):
        params, layers = random_stacked_params(cfg, "w4a8_2l", 128, seed=seed, device=dev)
        cache = StackedKVCache.create(cfg.num_layers, BATCH, SLAB, cfg.num_kv_heads,
                                      cfg.head_dim, device=dev)
        return (params, layers) + shard_for_tp(params, layers, cache, mesh, config=cfg)[1:]

    def new_cache(cfg, B):
        return StackedKVCache.create(cfg.num_layers, B, SLAB, cfg.num_kv_heads // tp,
                                     cfg.head_dim, device=dev)

    params, layers, s, c = shard(config, 0)
    del layers
    torch.cuda.empty_cache()
    ids = torch.randint(0, config.vocab_size, (BATCH, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))

    def prefill(cache, rows=ids):
        logits, cache = serving_forward_stacked(params, s, local, rows, cache=cache,
                                                logits_positions="last", tp_group=group)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    # warm-up (the kernels' first calls) on 8 rows of 16 tokens (each
    # o_proj and MLP output of a prefill crosses host memory through gloo)
    rows = min(8, BATCH)
    tok, warm = prefill(new_cache(config, rows), ids[:rows, :16].contiguous())
    make_tp_decode_loop(config, mesh, s, params, warm, 2)(params, s, warm, tok)
    del warm
    loop = make_tp_decode_loop(config, mesh, s, params, c, STEPS)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t1 = time.perf_counter()
    first, c = prefill(c)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tokens, c = loop(params, s, c, first)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    expect = {"dequant_paired": 7 * L, "flash_prefill": L, "w4a8_gemv": 1 + 7 * L * STEPS,
              "kv_append": L * STEPS, "flash_decode": L * STEPS, "w4a8_gemv_argmax": STEPS}
    if counts != expect:
        raise AssertionError(f"(t) rank {rank}: launch counts {counts} != expected {expect}")
    if c.length != PROMPT + STEPS or not ((tokens >= 0) & (tokens < config.vocab_size)).all():
        raise AssertionError(f"(t) rank {rank}: cache length or tokens out of range")
    # one decode step, rewriting the last row: wall by CUDA events on every
    # rank, device time from a profile on rank 0 (the same calls on both)
    step = make_tp_decode_step(config, mesh, s, params, c)
    pos = torch.tensor([PROMPT + STEPS - 1], device=dev)
    tok = tokens[:, -1:]
    step_ms = median_ms(lambda: step(params, s, c, tok, pos), n=5)
    step_dev = _rank_device_ms(rank, lambda: step(params, s, c, tok, pos))
    out = dict(counts=counts, prefill_ms=(t2 - t1) * 1e3,
               tok_s=BATCH * STEPS / (t3 - t2), step_ms=step_ms, step_device_ms=step_dev,
               peak_gib=peak, tokens=tokens.cpu())
    say(f"serve (t) rank {rank}: Llama-3-8B w4a8_2l g128 tp {tp}, prefill {BATCH}x{PROMPT} "
        f"{out['prefill_ms']:.1f} ms; decode {BATCH}x{STEPS} tokens {out['tok_s']:.1f} tok/s; "
        f"step wall {step_ms:.2f} ms, device {fmt_ms(step_dev)}; peak {peak:.2f} GiB; "
        f"launches {counts}")
    del params, s, c, loop, step
    torch.cuda.empty_cache()
    # depth 2: the one-card path on this rank, then the TP path with every
    # kernel call held against its plain version
    small = dataclasses.replace(config, num_layers=2)
    small_local = dataclasses.replace(local, num_layers=2)
    params, layers, s, c = shard(small, 1)
    ids = torch.randint(0, config.vocab_size, (BATCH, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(11))
    one = StackedKVCache.create(2, BATCH, SLAB, config.num_kv_heads, config.head_dim, device=dev)
    ref, one = serving_forward_stacked(params, layers, small, ids, cache=one,
                                       logits_positions="last")
    first = torch.argmax(ref[:, -1], dim=-1)[:, None]
    ref_step, _ = serving_forward_stacked(params, layers, small, first, one)
    checked = collections.Counter()

    def tp_path():
        logits, cache = serving_forward_stacked(params, s, small_local, ids, cache=c,
                                                logits_positions="last", tp_group=group)
        return logits, serving_forward_stacked(params, s, small_local, first, cache,
                                               tp_group=group)[0]

    got, got_step = _checked(tp_path, checked)
    rms = [_rel_rms(got[:, -1], ref[:, -1]), _rel_rms(got_step[:, -1], ref_step[:, -1])]
    say(f"serve (t) rank {rank} depth 2: kernel calls held against their plain versions: "
        f"{dict(checked)}; logits against the one-card path: relative RMS error prefill "
        f"{rms[0]:.4g}, decode step {rms[1]:.4g} (limit {TP_LOGIT_RMS})")
    if max(rms) > TP_LOGIT_RMS:
        raise AssertionError(f"(t) rank {rank}: TP logits off the one-card path: {rms}")
    out.update(depth2_rms=rms, checked=dict(checked), seconds=time.perf_counter() - t0)
    del params, layers, s, c, one
    torch.cuda.empty_cache()
    return out


def _ep_run(rank, dev, say):
    """Run (u) on this rank: (s)'s block at EP 2 (`expert_parallel_moe`:
    this rank's 4 experts, the output combined by all_reduce)."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.parallel import make_mesh
    from fastforward_tpu_torch.serving.moe import expert_parallel_moe

    mesh = make_mesh({"expert": PARALLEL_RANKS})
    block, xs = _moe_inputs(dev)
    out = {}
    for T, x in xs.items():
        fn = functools.partial(expert_parallel_moe, mesh, block, x)
        fn()
        torch.cuda.synchronize()
        reset_launch_counts()
        y = fn()
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        expect = {"w4a8_gemv": 2 * MOE["num_experts"] // PARALLEL_RANKS}
        if counts != expect:
            raise AssertionError(f"(u) rank {rank} T={T}: launch counts {counts} != {expect}")
        ms = median_ms(fn)
        say(f"moe (u) rank {rank} T={T}: EP {PARALLEL_RANKS}, {ms:.4f} ms a block (gloo "
            f"all_reduce included); launches {counts}")
        out[T] = dict(counts=counts, ms=ms, y=y.float().cpu())
    del block, xs
    torch.cuda.empty_cache()
    return out


def _rank_device_ms(rank, fn, n=3):
    """Device busy time a call of ``fn`` (kernels and copies), profiled on
    rank 0; every rank makes the same ``n`` calls (``fn`` may hold
    collectives). None on the other ranks, or where nothing was recorded."""
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with (profile(activities=[ProfilerActivity.CUDA]) if rank == 0 else nullcontext()) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    if rank != 0:
        return None
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0)
    return busy / n / 1e3 if busy > 0 else None


def _sp_inputs(dev):
    """(v)'s q, k, v, the same in every process on the card."""
    gen = torch.Generator(device=dev).manual_seed(31)
    return [torch.randn(SP_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(3)]


def _sp_run(rank, dev, say):
    """Run (v) on this rank: `context_parallel_attention` over an ``sp`` dim
    of both ranks (each its 2,048 positions; K/V one hop around the ring,
    through host memory under gloo), the full output on both."""
    from fastforward_tpu_torch.parallel import context_parallel_attention, make_mesh
    from fastforward_tpu_torch.parallel.transport import all_gather_cat, host_staged, ring_shift

    t0 = time.perf_counter()
    mesh = make_mesh({"sp": PARALLEL_RANKS})
    q, k, v = _sp_inputs(dev)
    fn = functools.partial(context_parallel_attention, mesh, q, k, v, "sp")
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = median_ms(fn, n=5)
    dms = _rank_device_ms(rank, fn)
    group = mesh.get_group("sp")
    hop = "host memory (gloo)" if host_staged(q, group) else \
        f"{torch.distributed.get_backend(group)} on {q.device.type}"
    # the transport alone: one hop of a rank's K and V blocks, and the
    # output's gather
    half = SP_SHAPE[2] // PARALLEL_RANKS
    kv = [t[:, :, :half].contiguous() for t in (k, v)]
    hop_ms = median_ms(lambda: ring_shift(kv, group), n=5)
    gather_ms = median_ms(lambda: all_gather_cat(out[:, :, :half].contiguous(), 2, group), n=5)
    say(f"context (v) rank {rank}: ring attention SP {PARALLEL_RANKS}, B {SP_SHAPE[0]} H "
        f"{SP_SHAPE[1]} T {SP_SHAPE[2]} D {SP_SHAPE[3]} bf16 causal, {ms:.2f} ms a call, device "
        f"{fmt_ms(dms)} (hops and the output's gather through {hop}: a K/V hop "
        f"{hop_ms:.2f} ms, the gather {gather_ms:.2f} ms); peak {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    if tuple(out.shape) != SP_SHAPE or not torch.isfinite(out.float()).all():
        raise AssertionError(f"(v) rank {rank}: output not finite {SP_SHAPE}")
    res = dict(ms=ms, device_ms=dms, hop_ms=hop_ms, gather_ms=gather_ms, peak_gib=peak,
               out=out.cpu(), seconds=time.perf_counter() - t0)
    del q, k, v, out
    torch.cuda.empty_cache()
    return res


def _pp_layers(dev):
    """(w)'s stacked QuantLinear, the same in every process on the card."""
    from fastforward_tpu_torch.serving.engine import QuantLinear, quantize_linear

    gen = torch.Generator(device=dev).manual_seed(41)
    qls = [quantize_linear(torch.randn((PP_WIDTH, PP_WIDTH), generator=gen, device=dev)
                           / PP_WIDTH ** 0.5, "w4a8_2l", 128) for _ in range(PP_LAYERS)]
    return QuantLinear(data=torch.stack([q.data for q in qls]),
                       scale=torch.stack([q.scale for q in qls]), mode="w4a8_2l",
                       group_size=128, mult=torch.stack([q.mult for q in qls]),
                       paired=qls[0].paired)


def _pp_run(rank, dev, say):
    """Run (w) on this rank: `pipeline_forward` over a ``stage`` dim of both
    ranks (16 layers each; microbatches sent stage to stage through host
    memory under gloo), every row-5 launch counted, every kernel call held
    against its plain version in a second call, and the output held bit for
    bit to this process's sequential loop over all 32 layers."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.parallel import make_mesh, pipeline_forward
    from fastforward_tpu_torch.serving.engine import QuantLinear

    t0 = time.perf_counter()
    mesh = make_mesh({"stage": PARALLEL_RANKS})
    layers = _pp_layers(dev)
    x = torch.randn((BATCH, PP_WIDTH), generator=torch.Generator(device=dev).manual_seed(43),
                    device=dev)

    def layer_fn(ql, h):
        return ql(h, out_dtype=torch.float32)

    fn = functools.partial(pipeline_forward, mesh, layers, x, layer_fn,
                           n_microbatches=PP_MICRO)
    fn()
    torch.cuda.synchronize()
    reset_launch_counts()
    y = fn()
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    expect = {"w4a8_gemv": PP_LAYERS // PARALLEL_RANKS * PP_MICRO}
    if counts != expect:
        raise AssertionError(f"(w) rank {rank}: launch counts {counts} != expected {expect}")
    checked = collections.Counter()
    if not torch.equal(_checked(fn, checked), y):
        raise AssertionError(f"(w) rank {rank}: the checked call gave other bits")

    def sequential():
        h = x
        for i in range(PP_LAYERS):
            h = layer_fn(QuantLinear(layers.data[i], layers.scale[i], "w4a8_2l", 128,
                                     layers.mult[i], layers.paired), h)
        return h

    ref = sequential()
    same = torch.equal(y, ref)
    ms, seq_ms = median_ms(fn, n=5), median_ms(sequential, n=5)
    dms, seq_dms = _rank_device_ms(rank, fn), _rank_device_ms(rank, sequential)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    say(f"pipeline (w) rank {rank}: PP {PARALLEL_RANKS}, {PP_LAYERS} w4a8_2l g128 layers of "
        f"{PP_WIDTH} x {PP_WIDTH}, x ({BATCH}, {PP_WIDTH}) f32 in {PP_MICRO} microbatches: "
        f"{ms:.2f} ms a forward, device {fmt_ms(dms)} (one process's sequential loop "
        f"{seq_ms:.2f} ms, device {fmt_ms(seq_dms)}); peak {peak:.2f} GiB; launches "
        f"{counts}; kernel calls held against their plain versions: {dict(checked)}; "
        f"{'bit-equal' if same else 'NOT bit-equal'} to the sequential loop; "
        f"{time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError(f"(w) rank {rank}: pipeline output off the sequential loop")
    res = dict(counts=counts, ms=ms, device_ms=dms, sequential_ms=seq_ms,
               sequential_device_ms=seq_dms, peak_gib=peak, checked=dict(checked), y=y.cpu(),
               seconds=time.perf_counter() - t0)
    del layers, x, y, ref
    torch.cuda.empty_cache()
    return res


def _dry_run(rank, dev, lines):
    """`dryrun_multichip` on both ranks (it prints its line on rank 0)."""
    from fastforward_tpu_torch.parallel import dryrun_multichip

    t0 = time.perf_counter()
    shapes = dryrun_multichip()
    lines.append(shapes["line"])
    return dict(line=shapes["line"], seconds=time.perf_counter() - t0)


def _parallel_worker(rank, world, port, tmp):
    """One rank of runs (t), (u), (v), (w) and the dry run: a gloo process
    group over localhost,
    both ranks on cuda:0; its results pickled to ``tmp``."""
    import pickle

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    try:
        res = {"t": _tp_run(rank, dev, say), "u": _ep_run(rank, dev, say),
               "v": _sp_run(rank, dev, say), "w": _pp_run(rank, dev, say),
               "dry": _dry_run(rank, dev, lines), "lines": lines}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_parallel(dev, moe_ref):
    """Runs (t), (u), (v), (w) and the dry run in PARALLEL_RANKS processes
    on the one card over gloo (`_parallel_worker`); both ranks must emit
    identical tokens, (u)'s output must match (s)'s within one bf16 ulp of
    the largest output (FLASH_RTOL: the two ranks' f32 partial sums are
    added in another order than one process's expert loop), (v)'s the
    dense attention's the same way, and (w)'s must be bit-equal on both
    ranks."""
    import pickle
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_parallel_worker, args=(PARALLEL_RANKS, port, tmp), nprocs=PARALLEL_RANKS,
                 join=True)
        ranks = []
        for r in range(PARALLEL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        for line in res["lines"]:
            if _LOG["file"] is not None:
                _LOG["file"].write(line + "\n")
    log(f"parallel (t)-(w): {PARALLEL_RANKS} processes on cuda:0 over gloo (its all_reduce, "
        f"and the ring hops and sends of (v) and (w), stage CUDA tensors through host memory: "
        f"not NCCL's transport), "
        f"{time.perf_counter() - t0:.1f} s with the spawn")
    t = [res["t"] for res in ranks]
    if not all(torch.equal(x["tokens"], t[0]["tokens"]) for x in t[1:]):
        raise AssertionError("(t): the ranks emitted different tokens")
    log(f"serve (t): both ranks emitted identical tokens ({BATCH}x{STEPS})")
    for T in MOE_TOKENS:
        ys = [res["u"][T]["y"] for res in ranks]
        if not all(torch.equal(y, ys[0]) for y in ys[1:]):
            raise AssertionError(f"(u) T={T}: the ranks hold different outputs")
        ref = moe_ref[T]["y"]
        err = (ys[0] - ref).abs().max().item()
        ok = err <= FLASH_RTOL * ref.abs().max().item()
        same = "bit-equal" if torch.equal(ys[0], ref) else "not bit-equal"
        log(f"moe (u) T={T}: EP {PARALLEL_RANKS} output {same} to (s)'s, max err {err:.4g} of "
            f"{ref.abs().max().item():.4g} (limit rtol {FLASH_RTOL})")
        if not ok:
            raise AssertionError(f"(u) T={T}: EP output off (s)'s")
    # (v): both ranks' full outputs bit-equal, and within one bf16 ulp of
    # the largest output of a one-process dense causal attention on the card
    outs = [res["v"]["out"] for res in ranks]
    if not all(torch.equal(o, outs[0]) for o in outs[1:]):
        raise AssertionError("(v): the ranks hold different outputs")
    t0 = time.perf_counter()
    q, k, v = _sp_inputs(dev)
    T = SP_SHAPE[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / SP_SHAPE[3] ** 0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    scores = torch.where(causal, scores, -1e30)
    dense = torch.matmul(torch.softmax(scores, dim=-1).to(torch.bfloat16), v).float().cpu()
    del q, k, v, scores, causal
    torch.cuda.empty_cache()
    err = (outs[0].float() - dense).abs().max().item()
    top = dense.abs().max().item()
    log(f"context (v): both ranks bit-equal; max err {err:.4g} of {top:.4g} against one "
        f"process's dense attention (limit rtol {FLASH_RTOL}); dense reference "
        f"{time.perf_counter() - t0:.1f} s")
    if err > FLASH_RTOL * top:
        raise AssertionError(f"(v): ring attention off the dense attention: {err} of {top}")
    ys = [res["w"]["y"] for res in ranks]
    if not all(torch.equal(y, ys[0]) for y in ys[1:]):
        raise AssertionError("(w): the ranks hold different outputs")
    log(f"pipeline (w): both ranks bit-equal, each to its own sequential loop; row-5 launches "
        f"a rank {[res['w']['counts'] for res in ranks]}")
    work = [round(res["v"]["seconds"] + res["w"]["seconds"] + res["dry"]["seconds"], 1)
            for res in ranks]
    log(f"parallel (v), (w), dry run: {work} s of the ranks' work")
    return dict(t={k: v for k, v in t[0].items() if k != "tokens"},
                t_rank1_tok_s=t[1]["tok_s"],
                u={T: {k: v for k, v in ranks[0]["u"][T].items() if k != "y"} for T in MOE_TOKENS},
                v={k: val for k, val in ranks[0]["v"].items() if k != "out"},
                w={k: val for k, val in ranks[0]["w"].items() if k != "y"},
                dry=ranks[0]["dry"])


def _quant_case(name, x, scale, offset, tile, bits, gen):
    """One static granularity of (x): quantize, dequantize and their
    backward on the card and on a CPU copy; forwards and the data gradient
    bit-equal, the scale and offset gradients within QUANT_GRAD_RTOL."""
    from fastforward_tpu_torch.quantization import affine

    def run(d, s, o, g):
        d, s, o = (t.clone().requires_grad_() for t in (d, s, o))
        q = affine.quantize_by_tile(d, s, o, tile_size=tile, num_bits=bits)
        y = affine.dequantize_by_tile(q, s, o, tile_size=tile)
        q.backward(g)
        return q.detach(), y.detach(), d.grad, s.grad, o.grad

    g = torch.randn(x.shape, generator=gen, device=x.device)
    run(x, scale, offset, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run(x, scale, offset, g)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    dms = device_ms(lambda: run(x, scale, offset, g), n=5)
    cpu = run(*(t.cpu() for t in (x, scale, offset, g)))
    card = [t.cpu() for t in card]
    for what, a, b in zip(("grid values", "dequantized", "data gradient"), card, cpu):
        if not torch.equal(a, b):
            raise AssertionError(f"(x) {name}: {what} not bit-equal to the CPU copy's")
    errs = []
    for what, a, b in zip(("scale", "offset"), card[3:], cpu[3:]):
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        errs.append(err)
        if err > QUANT_GRAD_RTOL:
            raise AssertionError(f"(x) {name}: {what} gradient {err:.3g} of the largest off")
    clipped = (card[2] == 0).float().mean().item()
    log(f"quant (x) {name} {tuple(x.shape)} tile {tile} {bits}-bit: forward, dequantize and "
        f"data gradient bit-equal to the CPU copy's; scale / offset gradients within "
        f"{errs[0]:.3g} / {errs[1]:.3g} of the largest (limit {QUANT_GRAD_RTOL}); "
        f"{clipped:.4f} of the values clipped; {card_ms:.1f} ms on the card for the three, "
        f"device {fmt_ms(dms)}")
    return dict(card_ms=card_ms, device_ms=dms, grad_rel_err=errs, clipped=clipped)


def phase_quant(dev):
    """Run (x): the simulation tier's core on the card, then the sim-tier KV
    append (`LayerKVCache.append(quantizer=)`): one fused K/V quantize-append
    launch at (h)'s cache shape, bit-equal to the plain append of the
    quantizer's QDQ'd k/v, then one flash decode over the cache."""
    from fastforward_tpu_torch import quantization as tq
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.kernels.attention import (
        flash_decode_int8,
        flash_decode_int8_reference,
    )
    from fastforward_tpu_torch.quantization import affine
    from fastforward_tpu_torch.serving.kv_cache import LayerKVCache

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(51)
    K, N = QUANT_SHAPE
    w = torch.randn(QUANT_SHAPE, generator=gen, device=dev) / K ** 0.5
    out = {}
    # per output channel, 8-bit, symmetric-range scales with offsets of a few levels
    s_ch = (w.abs().amax(dim=0) / 127.0) * 0.8
    o_ch = torch.randint(-3, 4, (N,), generator=gen, device=dev).float()
    out["per_channel"] = _quant_case("per channel", w, s_ch, o_ch, (K, 1), 8, gen)
    # per block of 128 along K, 4-bit
    s_blk = (w.reshape(K // 128, 128, N).abs().amax(dim=1) / 7.0 * 0.9).reshape(-1)
    o_blk = torch.randint(-1, 2, (K // 128 * N,), generator=gen, device=dev).float()
    out["per_block"] = _quant_case("per block", w, s_blk, o_blk, (128, 1), 4, gen)
    del w
    # dynamic per row on the decode batch's activations
    x = torch.randn((BATCH, 4096), generator=gen, device=dev) * 3
    card = affine.quantize_dynamic_by_tile(x, tile_size=(1, 4096))
    cpu = affine.quantize_dynamic_by_tile(x.cpu(), tile_size=(1, 4096))
    if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
        raise AssertionError("(x) dynamic per row: not bit-equal to the CPU copy's")
    log(f"quant (x) dynamic per row ({BATCH}, 4096) 8-bit: grid values, scales and offsets "
        f"bit-equal to the CPU copy's")

    # the sim-tier KV append at (h)'s shape: B 192, 8 kv heads, d 128, INT8
    class RowQuantizer:  # dynamic symmetric 8-bit per (batch, head, token) row
        is_stub = False

        def __call__(self, t):
            return tq.quantize_dynamically(t, tq.PerChannel((0, 1, 2)), num_bits=8,
                                           symmetric=True)

    Hkv, D, H = 8, 128, 32
    shape = (BATCH, Hkv, SLAB, D)
    cache = LayerKVCache(
        k=torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8),
        v=torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8),
        k_scale=torch.rand(shape[:3], generator=gen, device=dev) * 0.02,
        v_scale=torch.rand(shape[:3], generator=gen, device=dev) * 0.02)
    plain = LayerKVCache(*(t.cpu() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)))
    k_new, v_new = (torch.randn((BATCH, Hkv, 1, D), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
    pos = torch.randint(0, SLAB, (BATCH, 1), generator=gen, device=dev, dtype=torch.int32)
    quantizer = RowQuantizer()
    qdq = [t.cpu() for t in (quantizer(k_new).dequantize(), quantizer(v_new).dequantize())]
    torch.cuda.synchronize()
    reset_launch_counts()
    cache.append(k_new, v_new, pos, quantizer=quantizer)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    if counts != {"kv_append_layer": 1}:
        raise AssertionError(f"(x) sim-tier append: launch counts {counts}")
    plain.append(*qdq, pos.cpu())
    for f in ("k", "v", "k_scale", "v_scale"):
        if not torch.equal(getattr(cache, f).cpu(), getattr(plain, f)):
            raise AssertionError(f"(x) sim-tier append: {f} not bit-equal to the plain append")
    q = torch.randn((BATCH, H, D), generator=gen, device=dev).to(torch.bfloat16)
    lengths = (pos[:, 0] + 1).contiguous()
    reset_launch_counts()
    att = flash_decode_int8(q, cache.k, cache.k_scale, cache.v, cache.v_scale, lengths)
    torch.cuda.synchronize()
    counts_fd = dict(launch_counts)
    ref = flash_decode_int8_reference(q, cache.k, cache.k_scale, cache.v, cache.v_scale, lengths)
    err = (att.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    log(f"quant (x) sim-tier KV append (B {BATCH}, {Hkv} kv heads, S {SLAB}, d {D}, INT8): "
        f"launches {counts}, bit-equal to the plain append of the quantizer's QDQ'd k/v; flash "
        f"decode over it: launches {counts_fd}, max err {err:.4g} of {top:.4g} (limit rtol "
        f"{FLASH_RTOL}); phase work {time.perf_counter() - t0:.1f} s")
    if counts_fd != {"flash_decode_layer": 1} or err > FLASH_RTOL * top:
        raise AssertionError("(x) flash decode over the sim-tier cache off its plain version")
    del cache, plain
    torch.cuda.empty_cache()
    out["kv"] = dict(append_counts=counts, flash_counts=counts_fd, flash_err=err)
    return out


def _sim_layer(dev, gen):
    """One Llama-3-8B layer's seven projections as bf16 `torch.nn.Linear`s
    (weights N(0, 1 / in)), converted by `quantize_model`, each weight given
    an int8 symmetric per-output-channel `LinearQuantizer` at its min-max
    range."""
    from fastforward_tpu_torch import nn as tnn
    from fastforward_tpu_torch import quantization as tq

    layer = torch.nn.ModuleDict()
    for name, (K, N) in LAYER_PROJ.items():
        lin = torch.nn.Linear(K, N, bias=False, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            lin.weight.copy_(torch.randn((N, K), generator=gen, device=dev) / K ** 0.5)
        layer[name] = lin
    tnn.quantize_model(layer)
    for lin in layer.values():
        quant = tnn.LinearQuantizer(8, symmetric=True, granularity=tq.PerChannel(0),
                                    quantized_dtype=torch.int8)
        quant.quantization_range = (lin.weight.amin(dim=1), lin.weight.amax(dim=1))
        lin.weight_quantizer = quant
    return layer


def _cpu_copy(qt):
    from fastforward_tpu_torch.quantization import QuantizedTensor

    scale = qt.quant_args().scale
    scale = scale.detach().cpu() if isinstance(scale, torch.Tensor) else scale
    return QuantizedTensor(qt.raw_data.cpu(), qt.quantization_context.with_changes(scale=scale))


def _same_grid(what, card, cpu):
    a, b = card.quant_args(), cpu.quant_args()
    if not (torch.equal(card.raw_data.cpu(), cpu.raw_data)
            and torch.equal(torch.as_tensor(a.scale).detach().cpu(), torch.as_tensor(b.scale))
            and a.granularity == b.granularity):
        raise AssertionError(f"(y) {what}: grid, scale or granularity off the CPU copy's")


def phase_sim(dev):
    """Run (y): `quantize_model` on one Llama-3-8B layer's seven
    projections, int8 per-channel weight quantizers, the projections through
    `ops.linear` and the dispatcher onto row 19 at M = 192 and 8; checks,
    times and `freeze_parameters` as the module docstring says."""
    import torch.nn.functional as F

    from fastforward_tpu_torch import flags
    from fastforward_tpu_torch import quantization as tq
    from fastforward_tpu_torch.exceptions import QuantizationError
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.kernels.matmul import (
        matmul_w8a8,
        matmul_w8a8_reference,
        quantize_rowwise,
    )
    from fastforward_tpu_torch.quantization.freeze import freeze_parameters

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(61)
    torch.cuda.synchronize(dev)  # the context exists before the memory statistics are read
    base = torch.cuda.memory_allocated(dev)
    layer = _sim_layer(dev, gen)
    out = {"rel_rms": {}, "M": {}}
    with torch.no_grad():
        for M in (BATCH, 8):
            xs = {K: torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                  for K in {k for k, _ in LAYER_PROJ.values()}}

            def one_pass():
                return {name: lin(xs[LAYER_PROJ[name][0]]) for name, lin in layer.items()}

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            reset_launch_counts()
            ys = one_pass()
            torch.cuda.synchronize()
            counts = dict(launch_counts)
            # the layer's weights and what the pass allocates above them
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
            pass_peak = (torch.cuda.max_memory_allocated(dev) - before) / 2 ** 30
            if counts != {"w8a8_gemm": 7}:
                raise AssertionError(f"(y) M={M}: launch counts {counts}, expected 7 w8a8_gemm")
            qts, ops_in = {}, {}
            for name, lin in layer.items():
                x = xs[LAYER_PROJ[name][0]]
                qt = lin.weight_quantizer(lin.weight)
                x_q, x_s = quantize_rowwise(x)
                w_t = qt.raw_data.t().contiguous()
                w_s = qt.quant_args().scale.float().reshape(-1)
                ref = matmul_w8a8_reference(x_q, x_s, w_t, w_s, out_dtype=torch.bfloat16)
                if not torch.equal(ys[name], ref):
                    raise AssertionError(f"(y) M={M} {name}: row 19 off matmul_w8a8_reference "
                                         f"(err {max_err(ys[name], ref):.3g})")
                dense = F.linear(x, qt.dequantize())
                rms = _rel_rms(ys[name], dense)
                out["rel_rms"][f"{name} M={M}"] = rms
                if rms > SIM_RMS:
                    raise AssertionError(f"(y) M={M} {name}: relative RMS {rms:.4g} against the "
                                         f"dense fallback, limit {SIM_RMS}")
                reset_launch_counts()
                routed = F.linear(x, qt)
                torch.cuda.synchronize()
                if dict(launch_counts) != {"w8a8_gemm": 1} or not torch.equal(routed, ys[name]):
                    raise AssertionError(f"(y) M={M} {name}: F.linear on the QuantizedTensor "
                                         f"launched {dict(launch_counts)}, or other bits")
                qts[name], ops_in[name] = qt, (x, x_q, x_s, w_t, w_s)
            # the pass split into its parts, each timed alone on the same inputs
            parts = {
                "pass": one_pass,
                "weight quantizers": lambda: [lin.weight_quantizer(lin.weight)
                                              for lin in layer.values()],
                "transpose copy": lambda: [qt.raw_data.t().contiguous() for qt in qts.values()],
                "quantize_rowwise": lambda: [quantize_rowwise(o[0]) for o in ops_in.values()],
                "row 19": lambda: [matmul_w8a8(o[1], o[2], o[3], o[4], out_dtype=torch.bfloat16)
                                   for o in ops_in.values()],
            }
            # two profiles at most a part: a profiler that loses records
            # retries after half a second, and (y) is to stay cheap
            times = {k: dict(wall_ms=median_ms(fn, n=10), device_ms=device_ms(fn, n=5, tries=2))
                     for k, fn in parts.items()}
            out["M"][M] = dict(times=times, peak_gib=peak, pass_peak_gib=pass_peak)
            log(f"sim (y) M={M}: 7 w8a8_gemm launches a pass, each bit-equal to "
                f"matmul_w8a8_reference; relative RMS against the dense fallback up to "
                f"{max(v for k, v in out['rel_rms'].items() if k.endswith(f'M={M}')):.4g} "
                f"(limit {SIM_RMS}); F.linear(x, qt) one launch, same bits; peak "
                f"{peak:.2f} GiB above the phase's start, {pass_peak:.2f} GiB above the pass's")
            for k, v in times.items():
                log(f"sim (y) M={M} {k}: wall {v['wall_ms']:.4f} ms, device "
                    f"{fmt_ms(v['device_ms'])}")
            if M != 8:
                del ys, ops_in, parts
        # the QuantizedTensor operators against a CPU copy (strict quantization on)
        qt = qts["q"]
        cpu = _cpu_copy(qt)
        for what, fn in (("qt * 2.0", lambda t: t * 2.0), ("-qt", lambda t: -t),
                         ("torch.transpose", lambda t: torch.transpose(t, 0, 1))):
            _same_grid(what, fn(qt), fn(cpu))
        w = layer["q"].weight
        qpt = tq.quantize_per_tensor(w, (w.abs().amax().float() / 127).item(),
                                     quantized_dtype=torch.int8)
        _same_grid("torch.reshape", torch.reshape(qpt, (-1, 1024)),
                   torch.reshape(_cpu_copy(qpt), (-1, 1024)))
        try:
            qt + qt
        except QuantizationError:
            pass
        else:
            raise AssertionError("(y) qt + qt under strict quantization: no QuantizationError")
        with flags.strict_quantization(False):
            if not torch.equal(qt + qt, qt.dequantize() + qt.dequantize()):
                raise AssertionError("(y) qt + qt without strict quantization: not the dense sum")
        # frozen: the weights baked to their grid, no launch, the dense fallback's bits
        deq = {name: qts[name].dequantize() for name in layer}
        handles = freeze_parameters(layer)
        reset_launch_counts()
        with flags.strict_quantization(False):
            frozen = {name: lin(xs[LAYER_PROJ[name][0]]) for name, lin in layer.items()}
        torch.cuda.synchronize()
        if len(handles) != 7 or dict(launch_counts):
            raise AssertionError(f"(y) frozen: {len(handles)} handles, launches "
                                 f"{dict(launch_counts)}")
        for name in layer:
            if not torch.equal(frozen[name], F.linear(xs[LAYER_PROJ[name][0]], deq[name])):
                raise AssertionError(f"(y) frozen {name}: not the dense fallback's bits")
    log(f"sim (y): QuantizedTensor operators equal to the CPU copy's, qt + qt refused under "
        f"strict quantization; frozen: 0 launches, the dense fallback's bits; phase work "
        f"{time.perf_counter() - t0:.1f} s")
    del layer, qts, ops_in, deq, frozen
    torch.cuda.empty_cache()
    out["counts"] = {"w8a8_gemm": 7}
    return out


QUICKSTART_LAYERS = 2       # (z): Llama-3-8B's widths, depth cut for GPTQ's column loop
QUICKSTART_CALIB = (8, 128)  # (z): calibration sequences x tokens, seeded random ids
QUICKSTART_SIM = 16          # (z): prompts whose simulated logits the frozen ones are held to
QUICKSTART_RMS = 0.25        # (z): relative RMS of the frozen prefill logits to the simulated
QUICKSTART_BUDGET_S = 60.0   # (z): the phase's time limit


def _quickstart_rules(tnn, PerBlock):
    """The quickstart's three `QuantizationConfig` rules
    (`docs/quickstart_llm.md:27-46`, in torch's (out, in) layout): 8-bit per
    tensor on the parameters, 4-bit symmetric g128 blocks along the
    in-features (one per output channel) on Linear weights, 8-bit symmetric
    per tensor on every layer input."""
    from fastforward_tpu_torch import QuantizationConfig

    cfg = QuantizationConfig()
    cfg.add_rule("**/[quantizer:parameter]", tnn.LinearQuantizer, num_bits=8, symmetric=True)
    cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", tnn.LinearQuantizer,
                 num_bits=4, symmetric=True,
                 granularity=PerBlock(block_dims=1, block_sizes=128, per_channel_dims=0))
    cfg.add_rule("**/[quantizer:activation/input]", tnn.LinearQuantizer, num_bits=8,
                 symmetric=True)
    return cfg


def _quantizer_census(tnn, model):
    """{"<bits>-bit <granularity> <first tag>" or "stub": count} over the
    model's quantizer slots."""
    census = collections.Counter()
    for _, q in tnn.named_quantizers(model):
        if isinstance(q, tnn.QuantizerStub):
            census["stub"] += 1
        else:
            census[f"{q.num_bits}-bit {type(q.granularity).__name__} "
                   f"{q.quant_metadata.tags[0].name}"] += 1
    return dict(census)


def phase_quickstart(dev):
    """Run (z): the quickstart's simulation-to-serving path
    (`docs/quickstart_llm.md:14-60`) on a 2-layer Llama-3-8B: build,
    `quantize_model`, three `QuantizationConfig` rules, `estimate_ranges`
    (smoothed min-max) over 8 seeded 128-token sequences, GPTQ layer by
    layer (`layerwise_optimize_staged` over ``layers/*``), `freeze_llama`
    (w4a8 g128, static activations) and the per-layer serve (192 x 128
    prefill, 32 greedy steps, INT8 cache). Raises where a check fails (the
    module docstring lists them)."""
    import contextlib
    import importlib

    from fastforward_tpu_torch import estimate_ranges, flags, range_setting
    from fastforward_tpu_torch import nn as tnn
    from fastforward_tpu_torch.algorithms import layerwise_optimize_staged
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.kernels.matmul import dequantize_int4_reference
    from fastforward_tpu_torch.kernels.packing import unpack_int4
    from fastforward_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from fastforward_tpu_torch.quantization import PerBlock
    from fastforward_tpu_torch.serving.engine import freeze_llama

    # the module (the package's name `gptq` is the function)
    gptq_mod = importlib.import_module("fastforward_tpu_torch.algorithms.gptq")
    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)  # the context exists before the memory statistics are read
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    config = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=QUICKSTART_LAYERS)
    L, g = config.num_layers, 128
    secs = {}

    def mark(name, t0):
        torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0
        return secs[name]

    t0 = time.perf_counter()
    model = LlamaForCausalLM(config, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(71))
    mark("build", t0)

    # 1-2. convert and place the quantizers
    t0 = time.perf_counter()
    tnn.quantize_model(model)
    _quickstart_rules(tnn, PerBlock).initialize(model)
    mark("configuration", t0)
    census = _quantizer_census(tnn, model)
    n_lin, n_norm = 7 * L + 1, 2 * L + 1
    expect = {"4-bit PerBlock parameter/weight": n_lin,
              "8-bit PerTensor parameter/weight": n_norm + 1,  # the norms and the embedding
              "8-bit PerTensor parameter/bias": n_lin,  # installed; the Linears have no bias
              "8-bit PerTensor activation/input": n_lin + n_norm,
              "stub": n_lin + n_norm + 1 + 3 * L}  # outputs; attention scores, weights, KV
    log(f"quickstart (z): quantizers by bits, granularity and tag {census}")
    if census != expect:
        raise AssertionError(f"(z) the rules installed {census}, expected {expect}")

    # 3. calibrate
    gen = torch.Generator(device=dev).manual_seed(72)
    n_cal, t_cal = QUICKSTART_CALIB
    calib = [torch.randint(0, config.vocab_size, (1, t_cal), generator=gen, device=dev)
             for _ in range(n_cal)]
    cal_s = []
    with flags.strict_quantization(False), torch.no_grad():
        with estimate_ranges(model, range_setting.smoothed_minmax):
            for batch in calib:
                t0 = time.perf_counter()
                model(batch)
                cal_s.append(mark("calibration batch", t0))
    uninit = [n for n, q in tnn.named_quantizers(model)
              if getattr(q, "has_uninitialized_params", False) and not n.endswith("bias_quantizer")]
    if uninit:
        raise AssertionError(f"(z) quantizers left without a range after calibration: {uninit}")

    # 4. GPTQ, stage by stage; each projection held against round-to-nearest
    layer_of = {id(m): i for i, block in enumerate(model.layers) for m in block.modules()}
    name_of = {id(m): n for n, m in model.named_modules()}
    split = collections.defaultdict(lambda: collections.Counter())
    current = {"layer": 0}

    def timed_fn(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            split[current["layer"]][key] += time.perf_counter() - t
            return out
        return run

    worst = {}

    def algorithm(module, inputs, **kw):
        current["layer"] = layer_of[id(module)]
        w0 = module.weight.detach().clone()
        t = time.perf_counter()
        gptq_mod.gptq(module, inputs, **kw)
        torch.cuda.synchronize(dev)
        split[current["layer"]]["gptq"] += time.perf_counter() - t
        with torch.no_grad(), gptq_mod.full_f32_precision():
            quant = module.weight_quantizer
            x = inputs.float()
            ref = x @ w0.float().T
            err_gptq = torch.linalg.norm(x @ quant(module.weight).dequantize().float().T - ref)
            err_rtn = torch.linalg.norm(x @ quant(w0).dequantize().float().T - ref)
        name = name_of[id(module)]
        worst[name] = max(worst.get(name, 0.0), (err_gptq / err_rtn).item())
        if not err_gptq <= err_rtn:
            raise AssertionError(f"(z) GPTQ error {err_gptq.item():.6g} above round-to-nearest's "
                                 f"{err_rtn.item():.6g} on {name}")

    t0 = time.perf_counter()
    patched = [mock.patch.object(gptq_mod, k, timed_fn(k, getattr(gptq_mod, k)))
               for k in ("calculate_hessian", "invert_hessian", "_gptq_core")]
    with contextlib.ExitStack() as stack:
        for p in patched:
            stack.enter_context(p)
        optimized = layerwise_optimize_staged(
            model, calib, algorithm, stages="layers/*", forward=lambda m, b: m(b)[0],
            num_bits=4, granularity=PerBlock(block_dims=1, block_sizes=g, per_channel_dims=0))
    mark("gptq", t0)
    if len(optimized) != 7 * L:
        raise AssertionError(f"(z) GPTQ optimized {len(optimized)} projections, expected {7 * L}")
    for i in range(L):
        s_ = split[i]
        log(f"quickstart (z) GPTQ layer {i}: {s_['gptq']:.2f} s in gptq (Hessian "
            f"{s_['calculate_hessian']:.3f} s, inversion {s_['invert_hessian']:.3f} s, column "
            f"loop {s_['_gptq_core']:.2f} s)")
    log(f"quickstart (z): GPTQ error / round-to-nearest's on the captured inputs, per "
        f"projection: {', '.join(f'{k} {v:.4f}' for k, v in sorted(worst.items()))}")

    # 5. freeze; the frozen grids against the simulated ones
    t0 = time.perf_counter()
    params = freeze_llama(model, "w4a8", g, static_activations=True)
    mark("freeze", t0)
    static = 0
    with torch.no_grad():
        for i, (block, layer) in enumerate(zip(model.layers, params.layers)):
            for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                         "down_proj"):
                mod = getattr(block.self_attn if name[0] in "qkvo" else block.mlp, name)
                ql = getattr(layer, name)
                sim = mod.weight_quantizer(mod.weight)
                N, K = mod.weight.shape
                grid_sim = sim.raw_data.float()
                grid_frozen = unpack_int4(ql.data, g).float().t()
                scale_sim = sim.quant_args().scale.detach().reshape(N, K // g).t()
                deq_frozen = dequantize_int4_reference(ql.data, ql.scale, g).t()
                if not (torch.equal(grid_sim, grid_frozen) and torch.equal(scale_sim, ql.scale)
                        and torch.equal(sim.dequantize().to(torch.bfloat16), deq_frozen)):
                    raise AssertionError(f"(z) layer {i} {name}: the frozen grid, scales or "
                                         "dequantized weight differ from the simulated ones")
                static += ql.in_scale is not None
    if static != 7 * L:
        raise AssertionError(f"(z) {static} projections took a static input scale, expected {7 * L}")
    log(f"quickstart (z): {7 * L} frozen projections reproduce the simulated grids, scales and "
        f"dequantized bf16 weights bit for bit; {static} static input scales")

    # 6. serve: every kernel call against its plain version, then the measured run
    path = ServePath(config, params, kv="int8")
    ids = torch.randint(0, config.vocab_size, (BATCH, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(73))
    checked = collections.Counter()
    with contextlib.ExitStack() as stack:
        for p in _checked_patches(checked):
            stack.enter_context(p)
        _serve(path, ids, STEPS, dev)
    log(f"quickstart (z): kernel calls held against their plain versions on the same inputs: "
        f"{dict(checked)}")
    expect_counts = {"dequant_halves": 7 * L, "w4a8_gemv_halves": 7 * L * STEPS + 1 + STEPS,
                     "flash_prefill": L, "kv_append_layer": L * STEPS,
                     "flash_decode_layer": L * STEPS}
    reset_launch_counts()
    logits, first, tokens, cache, prefill_ms, decode_s = _serve(path, ids, STEPS, dev)
    counts = dict(launch_counts)
    log(f"quickstart (z): launches {counts}")
    if counts != expect_counts:
        raise AssertionError(f"(z) launch counts {counts} != expected {expect_counts}")
    if not torch.isfinite(logits).all() or not ((tokens >= 0) & (tokens < config.vocab_size)).all():
        raise AssertionError("(z) prefill logits not finite or tokens out of range")
    del cache
    with flags.strict_quantization(False), torch.no_grad():
        sim_logits = model(ids[:QUICKSTART_SIM])[0][:, -1].float()
    rms = _rel_rms(logits[:QUICKSTART_SIM, -1], sim_logits)
    log(f"quickstart (z): frozen prefill logits against the simulated model's, {QUICKSTART_SIM} "
        f"prompts: relative RMS {rms:.4g} (limit {QUICKSTART_RMS})")
    if not rms <= QUICKSTART_RMS:
        raise AssertionError(f"(z) frozen logits relative RMS {rms:.4g} > {QUICKSTART_RMS}")
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    out = dict(counts=counts, seconds=secs, calibration_batch_s=cal_s,
               gptq_split={i: dict(v) for i, v in split.items()}, gptq_vs_rtn=worst,
               prefill_ms=prefill_ms, decode_step_ms=decode_s * 1e3 / STEPS,
               tok_s=BATCH * STEPS / decode_s, rel_rms=rms, peak_gib=peak)
    log(f"quickstart (z): build {secs['build']:.2f} s, configuration {secs['configuration']:.3f} "
        f"s, calibration {min(cal_s):.3f}-{max(cal_s):.3f} s a batch, GPTQ {secs['gptq']:.2f} s "
        f"(2 stage passes and {7 * L} projections), freeze {secs['freeze']:.3f} s; prefill "
        f"{BATCH}x{PROMPT} {prefill_ms:.1f} ms, decode {out['decode_step_ms']:.2f} ms a step = "
        f"{out['tok_s']:.1f} tok/s; peak {peak:.2f} GiB above the phase's start")
    del model, params, path, logits, sim_logits
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    if took > QUICKSTART_BUDGET_S:
        raise AssertionError(f"(z) took {took:.1f} s, above its {QUICKSTART_BUDGET_S} s")
    return out


GPT2_BATCH, GPT2_CALIB = 8, 4    # (aa): the forward's sequences (of 1,024 tokens), calibration batches
GPT2_SQNR_DB = 20.0              # (aa): logits SQNR bar (tests/models/test_gpt2.py:50) ...
GPT2_SQNR_T = 64                 # ... on the first 64 positions (that test runs 16 tokens):
# on random weights the bar holds for short sequences only. Over 1,024 keys
# the attention is near uniform, its 8-bit weights round to a level or two
# and the per-tensor input ranges are set by the first positions' outputs:
# the JAX package's own model in the same configuration on the CPU (2
# layers, GPT-2-small's widths) gives 24.6 dB at T 64 and 10.15 dB at T
# 1,024 (PERF.md). At T 1,024 the phase requires GPT2_SQNR_FLOOR, which a
# wrong product or quantizer breaks (0 dB or less), and logs the number.
GPT2_SQNR_FLOOR = 5.0
GPT2_BRIDGE_TOL = 1e-5           # (aa): plan vs module path, share of the largest logit (the CPU test's)
GPT2_BRIDGE_BATCH = 2            # (aa): sequences of the bridge's calibration and evaluation batches
GPT2_EXPORT_T = 128              # (aa): tokens of the one sequence blocks 0-1 are exported on
GPT2_BUDGET_S = 90.0             # (aa): the phase's time limit
# (aa): row 19 at GPT-2-small's four projections, (K, N)
GPT2_PROJ = {"c_attn": (768, 2304), "c_proj": (768, 768), "fc_in": (768, 3072),
             "fc_out": (3072, 768)}


def _sqnr_db(ref, out):
    ref, out = ref.double(), out.double()
    return (10 * torch.log10(ref.square().mean() / (ref - out).square().mean())).item()


def _gpt2_w8a8_config(tnn, tq):
    """BASELINE config 2 in torch's layout (`tests/models/test_gpt2.py:30-47`):
    8-bit symmetric parameters per tensor (biases, norms, embeddings); int8
    symmetric Linear weights per output channel; 8-bit asymmetric
    activations per tensor."""
    from fastforward_tpu_torch import QuantizationConfig

    cfg = QuantizationConfig()
    cfg.add_rule("**/[quantizer:parameter]", tnn.LinearQuantizer, num_bits=8, symmetric=True)
    cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", tnn.LinearQuantizer,
                 num_bits=8, symmetric=True, granularity=tq.PerChannel(0),
                 quantized_dtype=torch.int8)
    cfg.add_rule("**/[quantizer:activation]", tnn.LinearQuantizer, num_bits=8, symmetric=False)
    return cfg


def _gpt2_bridge_config(tnn):
    """The fx plan's bridge configuration (JAX's `tests/test_autoquant_jaxpr.py:436`):
    8-bit symmetric Linear weights, 8-bit asymmetric Linear inputs, per tensor."""
    from fastforward_tpu_torch import QuantizationConfig

    cfg = QuantizationConfig()
    cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", tnn.LinearQuantizer,
                 num_bits=8, symmetric=True)
    cfg.add_rule("**/[cls:Linear]/[quantizer:activation/input]", tnn.LinearQuantizer,
                 num_bits=8, symmetric=False)
    return cfg


def phase_gpt2(dev):
    """Run (aa): GPT-2-small W8A8 (BASELINE config 2) at full width and
    depth through row 19, then autoquant, the fx plan, the module graph and
    export on the same model; the module docstring lists the checks."""
    import copy
    import tempfile

    from fastforward_tpu_torch import flags, range_setting
    from fastforward_tpu_torch import nn as tnn
    from fastforward_tpu_torch import quantization as tq
    from fastforward_tpu_torch.autoquant import autoquantize
    from fastforward_tpu_torch.autoquant_fx import scoped_forward, trace_quantization_sites
    from fastforward_tpu_torch.export import export
    from fastforward_tpu_torch.graph import run_scheduled, trace_modules
    from fastforward_tpu_torch.kernels import dispatch, launch_counts, reset_launch_counts
    from fastforward_tpu_torch.kernels.matmul import matmul_w8a8, matmul_w8a8_reference
    from fastforward_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)  # the context exists before the memory statistics are read
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    config = GPT2Config.small()
    L, T = config.num_layers, config.max_position_embeddings
    secs = {}

    def mark(name, t0):
        torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0
        return secs[name]

    # 1. build (seeded weights on the card) and the float forward
    t0 = time.perf_counter()
    model = GPT2LMHead(config, device=dev, generator=torch.Generator(device=dev).manual_seed(81))
    floats = copy.deepcopy(model), copy.deepcopy(model)  # the autoquant and fx-plan paths
    gen = torch.Generator(device=dev).manual_seed(82)
    ids = torch.randint(0, config.vocab_size, (GPT2_BATCH, T), generator=gen, device=dev)
    calib = [torch.randint(0, config.vocab_size, (GPT2_BATCH, T), generator=gen, device=dev)
             for _ in range(GPT2_CALIB)]
    mark("build", t0)
    t0 = time.perf_counter()
    with torch.no_grad():
        fp_logits = model(ids)
    mark("float forward", t0)

    # 2-3. convert, configure, calibrate (running min-max, then the weights'
    # minimum-error grid)
    t0 = time.perf_counter()
    tnn.quantize_model(model)
    _gpt2_w8a8_config(tnn, tq).initialize(model)
    mark("configuration", t0)
    linears = [m for b in model.blocks for m in (b.attn.c_attn, b.attn.c_proj, b.fc_in, b.fc_out)]
    t0 = time.perf_counter()
    with flags.strict_quantization(False), torch.no_grad():
        with range_setting.estimate_ranges(model, range_setting.running_minmax):
            for batch in calib:
                model(batch)
    mark("min-max calibration", t0)
    sqnr, short = {}, ids[:, :GPT2_SQNR_T]
    fp_short = fp_logits[:, :GPT2_SQNR_T].clone()  # causal: the prefix's own logits

    def sqnr_pair(label):
        sqnr[label] = dict(T1024=_sqnr_db(fp_logits, model(ids)),
                           T64=_sqnr_db(fp_short, model(short)))

    with flags.strict_quantization(False), torch.no_grad():
        sqnr_pair("min-max")
        t0 = time.perf_counter()
        for lin in linears:
            with range_setting.estimate_ranges(lin.weight_quantizer, range_setting.min_error_grid):
                lin.weight_quantizer(lin.weight)
        mark("MSE grid on the weights", t0)

    # 4. the quantized forward: every call held against its plain version
    # (not counted), then the counted forward
    checked, captured = [], {}
    real = dispatch.matmul_w8a8

    def checking(x_q, x_s, w_q, w_s, bias=None, out_dtype=torch.bfloat16):
        out = real(x_q, x_s, w_q, w_s, bias=bias, out_dtype=out_dtype)
        ref = matmul_w8a8_reference(x_q, x_s, w_q, w_s, bias, out_dtype)
        if not torch.equal(out, ref):
            raise AssertionError(f"(aa) row 19 at M={x_q.shape[0]} K={x_q.shape[1]} "
                                 f"N={w_q.shape[1]} off matmul_w8a8_reference "
                                 f"(err {max_err(out, ref):.3g})")
        checked.append(tuple(w_q.shape))
        captured.setdefault(tuple(w_q.shape), (x_q, x_s, w_q, w_s, bias))
        return out

    with flags.strict_quantization(False), torch.no_grad():
        with mock.patch.object(dispatch, "matmul_w8a8", checking):
            model(ids)
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = model(ids)
        mark("quantized forward", t0)
        counts = dict(launch_counts)
        sqnr_pair("min-max + MSE")
    if counts != {"w8a8_gemm": 4 * L} or len(checked) != 4 * L:
        raise AssertionError(f"(aa) launches {counts}, {len(checked)} checked; expected "
                             f"{4 * L} w8a8_gemm")
    log(f"gpt2 (aa): {4 * L} w8a8_gemm launches a forward of {GPT2_BATCH}x{T}, each bit-equal "
        f"to matmul_w8a8_reference on the same operands; logits SQNR against the float "
        f"forward after min-max {sqnr['min-max']['T64']:.2f} dB on the first "
        f"{GPT2_SQNR_T} positions (bar {GPT2_SQNR_DB}), {sqnr['min-max']['T1024']:.2f} dB "
        f"over {T} (floor {GPT2_SQNR_FLOOR}); after the weights' MSE grid "
        f"{sqnr['min-max + MSE']['T64']:.2f} and {sqnr['min-max + MSE']['T1024']:.2f} dB")
    if not (torch.isfinite(logits).all()
            and min(v["T64"] for v in sqnr.values()) >= GPT2_SQNR_DB
            and min(v["T1024"] for v in sqnr.values()) >= GPT2_SQNR_FLOOR):
        raise AssertionError(f"(aa) logits not finite, or SQNR {sqnr} below {GPT2_SQNR_DB} dB "
                             f"at T {GPT2_SQNR_T} or {GPT2_SQNR_FLOOR} dB at T {T}")
    del logits

    # the forward's times, split (each part timed alone on the same inputs)
    qts = [lin.weight_quantizer(lin.weight) for lin in linears]
    # each Linear's row-19 operands: those captured at its (K, N)
    operands = [captured[(lin.in_features, lin.out_features)] for lin in linears]

    def forward():
        with flags.strict_quantization(False), torch.no_grad():
            model(ids)

    parts = {
        "forward": forward,
        "weight quantizers": lambda: [lin.weight_quantizer(lin.weight) for lin in linears],
        "transpose copy": lambda: [qt.raw_data.t().contiguous() for qt in qts],
        "row 19": lambda: [matmul_w8a8(x_q, x_s, w_q, w_s, bias=b, out_dtype=torch.float32)
                           for x_q, x_s, w_q, w_s, b in operands],
    }
    times = {k: dict(wall_ms=median_ms(fn, n=3), device_ms=device_ms(fn, n=3, tries=2))
             for k, fn in parts.items()}
    dev_parts = [times[k]["device_ms"] for k in ("weight quantizers", "transpose copy", "row 19")]
    total = times["forward"]["device_ms"]
    rest = None if total is None or None in dev_parts else total - sum(dev_parts)
    for k, v in times.items():
        log(f"gpt2 (aa) {k}: wall {v['wall_ms']:.3f} ms, device {fmt_ms(v['device_ms'])}")
    log(f"gpt2 (aa) forward device time: row 19 {fmt_ms(dev_parts[2])}, transposed weight copy "
        f"{fmt_ms(dev_parts[1])}, weight quantizers {fmt_ms(dev_parts[0])}, the rest "
        f"{fmt_ms(rest)}")
    # row 19 at GPT-2's shapes, M = 8,192: the kernels line's rows
    rows = {}
    for name, (K, N) in GPT2_PROJ.items():
        x_q, x_s, w_q, w_s, bias = captured[(K, N)]
        M = x_q.shape[0]
        rows[name] = measure(
            "w8a8_gemm", f"gpt2 {name} M={M} K={K} N={N} f32",
            lambda: matmul_w8a8(x_q, x_s, w_q, w_s, bias=bias, out_dtype=torch.float32),
            lambda: matmul_w8a8_reference(x_q, x_s, w_q, w_s, bias, torch.float32),
            M * K + M * 4 + K * N + N * 4 + N * 4 + M * N * 4, 2 * M * K * N, INT8_OPS_PER_S,
            bit_equal, plain_n=2)
        rows[name]["library_ms"] = _int_mm_yardstick(f"w8a8_gemm gpt2 {name}", x_q, w_q)
    del qts, captured, operands, parts, fp_logits, fp_short
    torch.cuda.empty_cache()

    # 5. autoquant on a float copy, the fx plan on the other, one config
    t0 = time.perf_counter()
    m_mod, m_plan = floats
    b_cal, b_eval = ids[:GPT2_BRIDGE_BATCH], ids[GPT2_BRIDGE_BATCH:2 * GPT2_BRIDGE_BATCH]
    cfg = _gpt2_bridge_config(tnn)
    with torch.no_grad():
        autoquantize(m_mod, b_cal)
        with scoped_forward(m_plan):
            plan = trace_quantization_sites(lambda x: m_plan(x), b_cal)
    plan.install_from_config(cfg, m_mod, estimator=range_setting.running_minmax)
    cfg.initialize(m_mod)
    with flags.strict_quantization(False), torch.no_grad():
        with range_setting.estimate_ranges(m_mod, range_setting.running_minmax,
                                           disable_quantization=True):
            m_mod(b_cal)
        out_mod = m_mod(b_eval)
    plan.observe(b_cal)
    out_plan = plan.quantized(only_installed=True)(b_eval)
    mark("autoquant and fx plan", t0)
    bridge_err = max_err(out_plan, out_mod) / out_mod.abs().max().item()
    n_q = sum(1 for s in plan.sites if s.quantizers)
    log(f"gpt2 (aa) autoquant: sites {list(m_mod.autoquant_quantizers)} (JAX's GPT-2 has none); "
        f"fx plan: {len(plan.sites)} sites, {n_q} with quantizers from the config; plan vs "
        f"module path {bridge_err:.3g} of the largest logit (limit {GPT2_BRIDGE_TOL})")
    if n_q != 4 * L or not bridge_err <= GPT2_BRIDGE_TOL:
        raise AssertionError(f"(aa) bridge: {n_q} sites with quantizers, error {bridge_err:.3g}")
    del m_mod, m_plan, floats, plan, out_mod, out_plan
    torch.cuda.empty_cache()

    # 6. the module graph of the quantized model; the scheduled run over the blocks
    t0 = time.perf_counter()
    small = ids[:GPT2_BRIDGE_BATCH]
    seen = []
    with flags.strict_quantization(False), torch.no_grad():
        graph = trace_modules(model, small)
        handle = model.ln_f.register_forward_hook(lambda m, a, out: seen.append(out))
        want = model(small)
        coarse = graph(small)
        sched = run_scheduled(graph, [small])
        handle.remove()
    mark("module graph", t0)
    paths = [n.path for n in graph.nodes()]
    if not torch.equal(coarse, want) or paths != ["wte", "wpe"] + [f"blocks/{i}" for i in range(L)] \
            + ["ln_f"] or not torch.equal(sched["outputs"][0].raw_data, seen[0].raw_data):
        raise AssertionError(f"(aa) module graph: nodes {paths}, coarse or scheduled output off "
                             "the model's")
    log(f"gpt2 (aa) module graph: {len(list(graph.all_nodes()))} nodes, visible {len(paths)}; "
        f"coarse execution and the scheduled run (host-cached activations, ln_f's "
        f"quantized output, peak "
        f"{sched['stats']['peak_live_entries']} live entries) bit-equal to the model")
    del graph, sched, coarse, want, seen

    # 7. export blocks 0-1 of the calibrated model (the whole model's
    # program takes about a minute to trace, save and load: ~1,000 nodes a
    # block) on their captured input; the loaded .pt2 against the
    # export-mode forward
    t0 = time.perf_counter()
    one = ids[:1, :GPT2_EXPORT_T]
    inputs = []
    handle = model.blocks[0].register_forward_pre_hook(lambda m, a: inputs.append(a[0]))
    with flags.strict_quantization(False), torch.no_grad():
        model(one)
    handle.remove()
    two = torch.nn.Sequential(model.blocks[0], model.blocks[1])
    with tempfile.TemporaryDirectory() as tmp:
        paths_x = export(two, (inputs[0],), tmp, name="gpt2_w8a8_blocks01")
        program = torch.export.load(paths_x["program"])
        with torch.no_grad():
            got = program.module()(inputs[0])
            with flags.export_mode(True), flags.strict_quantization(False):
                want = two(inputs[0])
        n_enc = len(json.load(open(paths_x["encodings"]))["encodings"])
        size = os.path.getsize(paths_x["program"]) / 2 ** 20
    mark("export", t0)
    export_err = max_err(got, want)
    log(f"gpt2 (aa) export of blocks 0-1: .pt2 {size:.1f} MiB, {n_enc} encodings; the loaded "
        f"program vs the export-mode forward at 1x{GPT2_EXPORT_T}: max abs difference "
        f"{export_err:.3g} ({'bit-equal' if export_err == 0 else 'not bit-equal'})")
    if not torch.isfinite(got).all() or export_err > 1e-4 * want.abs().max().item():
        raise AssertionError(f"(aa) the exported program is off the export-mode forward "
                             f"({export_err:.3g})")
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    del model, two, program, got, want, inputs
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    log(f"gpt2 (aa): {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}; peak {peak:.2f} "
        f"GiB above the phase's start; phase {took:.1f} s")
    if took > GPT2_BUDGET_S:
        raise AssertionError(f"(aa) took {took:.1f} s, above its {GPT2_BUDGET_S} s")
    return dict(counts=counts, sqnr_db=sqnr, seconds=secs, times=times, rest_device_ms=rest,
                rows=rows, bridge_err=bridge_err, export_err=export_err, peak_gib=peak)



TIER_LAYERS = 2               # (ab): (z)'s model, Llama-3-8B's widths at 2 layers
TIER_BATCHES = (4, 2, 128)    # (ab): seeded batches x sequences x tokens (256 rows: the GEMVs)
TIER_REL_DELTA = 0.02         # (ab): |ppl_exec - ppl_sim| / ppl_sim (tests/test_tier_parity.py)
TIER_TRACE_TRIES = 4          # (ab): traced forwards until the trace holds the annotation and a kernel
TIER_BENCH_ITERS = 5          # (ab): profiling.benchmark's timed calls of the exec forward
TIER_BUDGET_S = 60.0          # (ab): the phase's time limit


def _tier_rules(tnn, tq, inputs):
    """(ab)'s `QuantizationConfig` (tests/test_tier_parity.py:26-32,
    :95-101, in torch's (out, in) layout): 4-bit symmetric g128 blocks
    along the in-features on every Linear weight, or (``inputs``) 8-bit
    symmetric per-tensor Linear inputs."""
    from fastforward_tpu_torch import QuantizationConfig

    cfg = QuantizationConfig()
    if inputs:
        cfg.add_rule("**/[cls:Linear]/[quantizer:activation/input]", tnn.LinearQuantizer,
                     num_bits=8, symmetric=True, allow_one_sided=False,
                     granularity=tq.PerTensor())
    else:
        cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", tnn.LinearQuantizer,
                     num_bits=4, symmetric=True, allow_one_sided=False,
                     granularity=tq.PerBlock(block_dims=1, block_sizes=128, per_channel_dims=0))
    return cfg


def _tier_weight_ranges(tnn, model, g=128):
    """Symmetric min-max ranges from each Linear's weight, one a g-block of
    the in-features (tests/test_tier_parity.py:35-46)."""
    for m in model.modules():
        if isinstance(m, tnn.QuantizedLinear):
            w = m.weight.detach().float()
            N, K = w.shape
            mabs = w.reshape(N, K // g, g).abs().amax(-1).reshape(-1)
            m.weight_quantizer.quantization_range = (-mabs, mabs)


def _tree_tensors(tree, path=""):
    """(path, tensor) of every tensor of a params tree (dataclasses,
    tuples, lists, dicts)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tree_tensors(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _tree_tensors(v, f"{path}.{i}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_tensors(v, f"{path}.{k}")


def _same_bytes(what, a, b):
    """Raise unless two params trees hold the same tensors byte for byte
    (dtypes, shapes, devices); returns (tensors, bytes)."""
    ta, tb = list(_tree_tensors(a)), list(_tree_tensors(b))
    if [p for p, _ in ta] != [p for p, _ in tb]:
        raise AssertionError(f"(ab) {what}: the trees differ")
    nbytes = 0
    for (path, x), (_, y) in zip(ta, tb):
        if (x.dtype, x.shape, x.device) != (y.dtype, y.shape, y.device) or not torch.equal(
                x.contiguous().view(-1).view(torch.uint8), y.contiguous().view(-1).view(torch.uint8)):
            raise AssertionError(f"(ab) {what}: {path} differs")
        nbytes += x.numel() * x.element_size()
    return len(ta), nbytes


def phase_tier(dev):
    """Run (ab): BASELINE's tier-parity criterion and the checkpoint round
    trips on a 2-layer Llama-3-8B (the module docstring lists the checks).
    Raises where a check fails."""
    import contextlib
    import shutil
    import tempfile

    from fastforward_tpu_torch import estimate_ranges, flags, range_setting
    from fastforward_tpu_torch import nn as tnn
    from fastforward_tpu_torch import quantization as tq
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from fastforward_tpu_torch.serving.engine import freeze_llama, serving_forward
    from fastforward_tpu_torch.utils import checkpoint, profiling
    from fastforward_tpu_torch.utils.evaluation import perplexity_delta
    from fastforward_tpu_torch.utils.metrics import sqnr

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)  # the context exists before the memory statistics are read
    torch.cuda.reset_peak_memory_stats(dev)
    config = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=TIER_LAYERS)
    L, g = config.num_layers, 128
    per_forward = 7 * L + 1  # the projections and the lm_head, each one GEMV at 256 rows
    secs = {}

    def mark(name, t0):
        torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0
        return secs[name]

    def build():
        model = LlamaForCausalLM(config, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(74))
        tnn.quantize_model(model)
        _tier_rules(tnn, tq, inputs=False).initialize(model)
        return model

    def counted(what, fn, expect):
        reset_launch_counts()
        out = fn()
        counts = dict(launch_counts)
        if counts != expect:
            raise AssertionError(f"(ab) {what}: launch counts {counts} != expected {expect}")
        return out, counts

    t0 = time.perf_counter()
    model = build()
    _tier_weight_ranges(tnn, model, g)
    mark("build and weight ranges", t0)
    n, B, T = TIER_BATCHES
    gen = torch.Generator(device=dev).manual_seed(75)
    batches = [torch.randint(0, config.vocab_size, (B, T), generator=gen, device=dev)
               for _ in range(n)]

    def sim_forward(ids):
        with flags.strict_quantization(False), torch.no_grad():
            return model(ids)[0]

    def exec_of(params):
        return lambda ids: serving_forward(params, config, ids)[0]

    parity = {}

    def tier_parity(label, params, count):
        fwd = exec_of(params)
        checked = collections.Counter()
        with contextlib.ExitStack() as stack:
            for p in _checked_patches(checked):
                stack.enter_context(p)
            fwd(batches[0])
        t0 = time.perf_counter()
        (ppl_sim, ppl_exec, delta), counts = counted(
            f"{label} perplexities", lambda: perplexity_delta(sim_forward, fwd, batches),
            {count: n * per_forward})
        took = mark(f"{label} perplexities", t0)
        rel = delta / ppl_sim
        db = sqnr(sim_forward(batches[0]), fwd(batches[0])).item()
        log(f"tier (ab) {label}: ppl sim {ppl_sim:.6g}, exec {ppl_exec:.6g}, delta {delta:.6g} "
            f"(relative {rel:.4g}, limit {TIER_REL_DELTA}); exec logits SQNR against the sim "
            f"tier's {db:.2f} dB; {n} x {B} x {T} ids, {took:.2f} s; launches {counts}; kernel "
            f"calls held against their plain versions {dict(checked)}")
        if not rel < TIER_REL_DELTA:
            raise AssertionError(f"(ab) {label}: relative perplexity delta {rel:.4g} >= "
                                 f"{TIER_REL_DELTA}")
        parity[label] = dict(ppl_sim=ppl_sim, ppl_exec=ppl_exec, delta=delta, rel_delta=rel,
                             sqnr_db=db, counts=counts, checked=dict(checked), seconds=took)

    # 1-2. W4A16 on the weight-only model (row 17), then static A8 (row 16)
    t0 = time.perf_counter()
    params16 = freeze_llama(model, "w4a16", g)
    mark("freeze w4a16", t0)
    tier_parity("w4a16", params16, "w4_gemv")
    del params16
    t0 = time.perf_counter()
    _tier_rules(tnn, tq, inputs=True).initialize(model)
    with flags.strict_quantization(False), torch.no_grad():
        with estimate_ranges(model, range_setting.running_minmax):
            for ids in batches:
                model(ids)
    mark("input calibration", t0)
    t0 = time.perf_counter()
    params8 = freeze_llama(model, "w4a8", g, static_activations=True)
    mark("freeze w4a8", t0)
    static = sum(getattr(layer, name).in_scale is not None for layer in params8.layers
                 for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                              "down_proj"))
    if static != 7 * L:
        raise AssertionError(f"(ab) {static} projections took a static input scale, expected {7 * L}")
    tier_parity("w4a8 static", params8, "w4a8_gemv_halves")

    tmp = tempfile.mkdtemp(prefix="ff_tier_")
    try:
        # 3. the quantization state, into a fresh model of the same seed
        state_dir = os.path.join(tmp, "state")
        t0 = time.perf_counter()
        checkpoint.save_quantization_state(model, state_dir, name_or_path="llama-3-8b-2-layers")
        mark("state save", t0)
        fresh = build()
        _tier_rules(tnn, tq, inputs=True).initialize(fresh)
        t0 = time.perf_counter()
        checkpoint.load_quantization_state(fresh, state_dir, name_or_path="llama-3-8b-2-layers")
        mark("state load", t0)
        pairs = list(zip(tnn.named_quantizers(model), tnn.named_quantizers(fresh)))
        n_params = 0
        for (name, q), (name2, q2) in pairs:
            if name != name2 or type(q) is not type(q2):
                raise AssertionError(f"(ab) state: {name} / {name2} differ after the load")
            for attr in ("scale", "offset"):
                a, b = getattr(q, attr, None), getattr(q2, attr, None)
                if (a is None) != (b is None) or (a is not None and not (
                        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b))):
                    raise AssertionError(f"(ab) state: {name}.{attr} not bit-equal after the load")
                n_params += a is not None
        frozen = freeze_llama(fresh, "w4a8", g, static_activations=True)
        n_t, n_b = _same_bytes("frozen w4a8 params of the reloaded state", params8, frozen)
        state_bytes = sum(os.path.getsize(os.path.join(state_dir, f)) for f in os.listdir(state_dir))
        log(f"tier (ab) state: {len(pairs)} quantizer slots, {n_params} scales and offsets "
            f"bit-equal after the round trip; the reloaded model frozen in w4a8 gives {n_t} "
            f"tensors ({n_b / 1e9:.3f} GB) byte-equal to the calibrated model's; {state_bytes} "
            f"bytes on disk, save {secs['state save']:.3f} s, load {secs['state load']:.3f} s")
        del fresh, frozen

        # 4. the frozen params, onto the card
        params_dir = os.path.join(tmp, "params")
        fwd8 = exec_of(params8)
        before, _ = counted("params before", lambda: fwd8(batches[0]),
                            {"w4a8_gemv_halves": per_forward})
        t0 = time.perf_counter()
        written = checkpoint.save_params(params8, params_dir)
        write_s = mark("params save", t0)
        t0 = time.perf_counter()
        loaded = checkpoint.load_params(params_dir, template=params8)
        read_s = mark("params load", t0)
        n_t, n_b = _same_bytes("loaded params", params8, loaded)
        after, _ = counted("params after", lambda: exec_of(loaded)(batches[0]),
                           {"w4a8_gemv_halves": per_forward})
        if not torch.equal(before, after):
            raise AssertionError("(ab) params: serving_forward's logits differ after the round trip")
        log(f"tier (ab) params: {n_t} tensors ({n_b / 1e9:.3f} GB) byte-equal after save_params / "
            f"load_params, logits bit-equal; {written / 1e9:.3f} GB written in {write_s:.3f} s "
            f"({written / 1e9 / write_s:.2f} GB/s), read onto the card in {read_s:.3f} s "
            f"({written / 1e9 / read_s:.2f} GB/s)")
        del loaded, before, after

        # 5. profiling
        trace_dir = os.path.join(tmp, "trace")
        found, tries = [], 0
        while not found and tries < TIER_TRACE_TRIES:
            tries += 1
            reset_launch_counts()
            with profiling.trace_to(trace_dir):
                with profiling.annotate("tier/exec_forward"):
                    fwd8(batches[0])
                    torch.cuda.synchronize(dev)
            if dict(launch_counts) != {"w4a8_gemv_halves": per_forward}:
                raise AssertionError(f"(ab) traced forward: launch counts {dict(launch_counts)}")
            with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
                text = f.read()
            if "tier/exec_forward" in text:
                found = [k for k in PORT_KERNELS if k in text]
        if not found:
            raise AssertionError(f"(ab) no trace of {TIER_TRACE_TRIES} names the annotation and "
                                 "a kernel of the port")
        bench, _ = counted("benchmark", lambda: profiling.benchmark(
            fwd8, batches[0], iters=TIER_BENCH_ITERS, warmup=1),
            {"w4a8_gemv_halves": (TIER_BENCH_ITERS + 1) * per_forward})
        mem = profiling.device_memory_stats(dev)
        peak = mem["peak_bytes_in_use"] / 2 ** 30
        log(f"tier (ab) profiling: the trace names 'tier/exec_forward' and {found} (try {tries}); "
            f"exec forward of {B} x {T} ids: mean {bench['mean_s'] * 1e3:.2f} ms, best "
            f"{bench['best_s'] * 1e3:.2f} ms over {TIER_BENCH_ITERS}; peak {peak:.2f} GiB "
            f"(device_memory_stats)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, params8, fwd8
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    log(f"tier (ab): {took:.1f} s; " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items()))
    if took > TIER_BUDGET_S:
        raise AssertionError(f"(ab) took {took:.1f} s, above its {TIER_BUDGET_S} s")
    return dict(parity=parity, seconds=secs, phase_s=took, state_bytes=state_bytes,
                params_bytes=written, write_gb_s=written / 1e9 / write_s,
                read_gb_s=written / 1e9 / read_s, trace_kernels=found, trace_tries=tries,
                benchmark=bench, peak_gib=peak)



SOURCES = {
    "a4_gemv": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                "fastforward_tpu/kernels/matmul.py:1406 (body :1342)"),
    "w4a8_gemv": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                  "fastforward_tpu/kernels/matmul.py:571 (paired body :537, pallas_call :620)"),
    "w4a8_gemv_argmax": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                         "fastforward_tpu/kernels/matmul.py:708 (kernel :650, pallas_call :744)"),
    "kv_append": ("fastforward_tpu_torch/csrc/kv_append.cu",
                  "fastforward_tpu/kernels/kv_update.py:100"),
    "flash_decode": ("fastforward_tpu_torch/csrc/flash_decode.cu",
                     "fastforward_tpu/kernels/attention.py:635 (and :271)"),
    "dequant_vertical": ("fastforward_tpu_torch/csrc/dequant.cu",
                         "fastforward_tpu/kernels/matmul.py:1736"),
    "dequant_paired": ("fastforward_tpu_torch/csrc/dequant.cu",
                       "fastforward_tpu/kernels/matmul.py:1650"),
    "w4a8_gemv_stacked": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                          "fastforward_tpu/kernels/matmul.py:1023"),
    "flash_prefill": ("fastforward_tpu_torch/csrc/flash_prefill.cu",
                      "fastforward_tpu/kernels/attention.py:971"),
    "paged_kv_append": ("fastforward_tpu_torch/csrc/kv_append.cu",
                        "fastforward_tpu/kernels/paged_attention.py:293"),
    "paged_flash_decode": ("fastforward_tpu_torch/csrc/flash_decode.cu",
                           "fastforward_tpu/kernels/paged_attention.py:156"),
    "fused_o_mlp": ("fastforward_tpu_torch/csrc/fused_tail.cu",
                    "fastforward_tpu/kernels/matmul.py:2298"),
    "dequant_halves": ("fastforward_tpu_torch/csrc/dequant.cu",
                       "fastforward_tpu/kernels/matmul.py:1561 (kernel :1535)"),
    "w4a8_gemv_halves": ("fastforward_tpu_torch/csrc/w4a8_halves.cu",
                         "fastforward_tpu/kernels/matmul.py:341 (kernel :312, pallas_call :363)"),
    "w4_gemv": ("fastforward_tpu_torch/csrc/w4_gemv.cu",
                "fastforward_tpu/kernels/matmul.py:262 (kernel :240; routed by :1832)"),
    "w8a8_gemm": ("fastforward_tpu_torch/csrc/w8a8_gemm.cu",
                  "fastforward_tpu/kernels/matmul.py:95 (kernel :78, pallas_call :127)"),
    "kv_append_layer": ("fastforward_tpu_torch/csrc/kv_append.cu",
                        "fastforward_tpu/kernels/kv_update.py:219"),
    "flash_decode_layer": ("fastforward_tpu_torch/csrc/flash_decode.cu",
                           "fastforward_tpu/kernels/attention.py:721"),
    "flash_prefill_bf16": ("fastforward_tpu_torch/csrc/flash_prefill.cu",
                           "fastforward_tpu/kernels/attention.py:971 (bf16 KV branch)"),
    "w4a8_gemv_unpaired": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                           "fastforward_tpu/kernels/matmul.py:571 (unpaired kernel :479)"),
    "fused_norm_qkv": ("fastforward_tpu_torch/csrc/fused_head.cu",
                       "fastforward_tpu/kernels/matmul.py:2615 (kernel :2436)"),
    "fused_norm_qkv_a4": ("fastforward_tpu_torch/csrc/fused_head.cu",
                          "fastforward_tpu/kernels/matmul.py:2539 (kernel :2485)"),
    "fused_o_gu": ("fastforward_tpu_torch/csrc/fused_tail.cu",
                   "fastforward_tpu/kernels/matmul.py:2118 (kernel :2051)"),
    "w4a8_gemv_preblocked": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                             "fastforward_tpu/kernels/matmul.py:1023 (pre-blocked layout, "
                             ":1055-1066, :1211-1214)"),
    "w4a8_gemv_manual": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                         "fastforward_tpu/kernels/matmul.py:879 (call :1107)"),
    "w4a8_gemv_splitw": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                         "fastforward_tpu/kernels/matmul.py:989 (call :1185)"),
    "dequant_paired_preblocked": ("fastforward_tpu_torch/csrc/dequant.cu",
                                  "fastforward_tpu/kernels/matmul.py:1650 (pre-blocked branch "
                                  ":1666-1686, call :1709)"),
    "w4a8_gemv_dotraw": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                         "fastforward_tpu/kernels/matmul.py:949 (picked at :1205-1208)"),
    "w4a8_gemv_concat": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                         "fastforward_tpu/kernels/matmul.py:780 (entered at :834-842)"),
    "w4a16_gemm": ("fastforward_tpu_torch/csrc/w4_wgmma.cuh",
                   "fastforward_tpu/kernels/matmul.py:1813 (pallas_call :1866)"),
    "kv_quantize_append": ("fastforward_tpu_torch/csrc/kv_append.cu",
                           "fastforward_tpu/kernels/kv_update.py:100 (after "
                           "serving/kv_cache.py:24 _quantize_kv)"),
    "kv_quantize_append_layer": ("fastforward_tpu_torch/csrc/kv_append.cu",
                                 "fastforward_tpu/kernels/kv_update.py:219 (after "
                                 "serving/kv_cache.py:24 _quantize_kv)"),
    "paged_kv_quantize_append": ("fastforward_tpu_torch/csrc/kv_append.cu",
                                 "fastforward_tpu/kernels/paged_attention.py:293 (after "
                                 "serving/kv_cache.py:24 _quantize_kv)"),
    "w4a8_gemv_halves_down_g112": ("fastforward_tpu_torch/csrc/w4a8_halves.cu",
                                   "fastforward_tpu/kernels/matmul.py:341 (kernel :312, g 112)"),
    "w4_gemv_down_g112": ("fastforward_tpu_torch/csrc/w4_gemv.cu",
                          "fastforward_tpu/kernels/matmul.py:262 (kernel :240, g 112)"),
    "w4a16_gemm_down_g112": ("fastforward_tpu_torch/csrc/w4_wgmma.cuh",
                             "fastforward_tpu/kernels/matmul.py:1813 (g 112)"),
    "w4a8_gemv_halves_g16": ("fastforward_tpu_torch/csrc/w4a8_halves.cu",
                             "fastforward_tpu/kernels/matmul.py:341 (kernel :312, g 16)"),
    "w4_gemv_g16": ("fastforward_tpu_torch/csrc/w4_gemv.cu",
                    "fastforward_tpu/kernels/matmul.py:262 (kernel :240, g 16)"),
    "w4a16_gemm_g16": ("fastforward_tpu_torch/csrc/w4_wgmma.cuh",
                       "fastforward_tpu/kernels/matmul.py:1813 (g 16)"),
    "a4_gemv_any": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                    "fastforward_tpu/kernels/matmul.py:1406 (body :1342, any group)"),
    "w4a8_gemv_any": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                      "fastforward_tpu/kernels/matmul.py:571 (paired body :537, any group)"),
    "w4a8_gemv_unpaired_any": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                               "fastforward_tpu/kernels/matmul.py:571 (unpaired kernel :479, "
                               "any group)"),
    "w4a8_gemv_stacked_any": ("fastforward_tpu_torch/csrc/w4a8_mma.cuh",
                              "fastforward_tpu/kernels/matmul.py:1023 (any group, flat and "
                              "pre-blocked)"),
    "fused_norm_qkv_any": ("fastforward_tpu_torch/csrc/fused_head.cu",
                           "fastforward_tpu/kernels/matmul.py:2615 (kernel :2436, any group)"),
    "fused_norm_qkv_a4_any": ("fastforward_tpu_torch/csrc/fused_head.cu",
                              "fastforward_tpu/kernels/matmul.py:2539 (kernel :2485, any group)"),
    "fused_o_mlp_any": ("fastforward_tpu_torch/csrc/fused_tail.cu",
                        "fastforward_tpu/kernels/matmul.py:2298 (any group)"),
    "fused_o_gu_any": ("fastforward_tpu_torch/csrc/fused_tail.cu",
                       "fastforward_tpu/kernels/matmul.py:2118 (kernel :2051, any group)"),
    **{name: ("fastforward_tpu_torch/csrc/probe_int4.cu",
              "scripts/tpu_probe_int4.py:67 (kernel :44)")
       for name in ("probe_dp4a", "probe_mma_s8", "probe_mma_s8_int4", "probe_mma_s4",
                    "probe_mma_bf16")},
}


# Entries the port's main path does not launch (0 launches, the
# "main_path" key false): row 18's tiled W4A16 body (at g128 and at the
# permuted route's groups) and row 24's probe (no path of the JAX package
# serves through them), rows 16 and 17 at g 112 (no run serves that
# group), the any-group routes of row 5 (both layouts) and of the fused
# routes (no served default reaches their groups; rows 1 and 9 at g 14 are
# run (ag)'s), and the int8-input appends, whose
# rows the decode step now launches through the fused K/V quantize and
# append under the same counts (COUNT_OF).
OFF_MAIN_PATH = ("w4a16_gemm", "probe_dp4a", "probe_mma_s8", "probe_mma_s8_int4",
                 "probe_mma_s4", "probe_mma_bf16", "w4a16_gemm_down_g112", "w4a16_gemm_g16",
                 "w4a8_gemv_halves_down_g112", "w4_gemv_down_g112",
                 "kv_append", "kv_append_layer", "paged_kv_append",
                 "w4a8_gemv_any", "w4a8_gemv_unpaired_any",
                 "fused_norm_qkv_any", "fused_norm_qkv_a4_any", "fused_o_mlp_any",
                 "fused_o_gu_any")
# The launch count a kernels-line entry reads where it is not its own name.
COUNT_OF = {"kv_quantize_append": "kv_append", "kv_quantize_append_layer": "kv_append_layer",
            "paged_kv_quantize_append": "paged_kv_append",
            **{f"{row}_{at}": row for row in ("w4a8_gemv_halves", "w4_gemv", "w4a16_gemm")
               for at in ("down_g112", "g16")}}
# The runs whose launch counts a kernels-line entry reads where the first
# run of the main path that launched its count served another group: the
# permuted route of rows 16 and 17 at g 16 (run (ac)), the two-level
# GEMVs' any-group route at g 14 (run (ag)).
RUN_OF = {"w4a8_gemv_halves_g16": ("ac8",), "w4_gemv_g16": ("ac16",),
          "a4_gemv_any": ("ag4",), "w4a8_gemv_stacked_any": ("ag8",)}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import fastforward_tpu_torch  # noqa: F401  (fails outside the repository)

    out_dir = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        _LOG["file"] = open(os.path.join(out_dir, "chip_smoke.log"), "w")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    t_all = time.perf_counter()
    phases = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        phases[name] = time.perf_counter() - t0
        log(f"phase {name}: {phases[name]:.1f} s")
        return result

    with flag_env():  # no serving flag set, but where a run sets its own
        timed("build", phase_build)
        rows = timed("kernels", phase_kernels, dev)
        runs = timed("serve", phase_serve, dev)
        runs["engine"] = timed("engine", phase_engine, dev)
        runs["j"] = timed("loader", phase_loader, dev)
        moe = timed("moe", phase_moe, dev)
        runs["s"] = {"counts": moe[BATCH]["counts"],
                     **{f"T{T}": {k: v for k, v in r.items() if k != "y"} for T, r in moe.items()}}
        runs["tu"] = timed("parallel", phase_parallel, dev, moe)
        runs["x"] = timed("quant", phase_quant, dev)
        runs["y"] = timed("sim", phase_sim, dev)
        runs["z"] = timed("quickstart", phase_quickstart, dev)
        runs["aa"] = timed("gpt2", phase_gpt2, dev)
        runs["ab"] = timed("tier", phase_tier, dev)
    log(f"total {time.perf_counter() - t_all:.1f} s; work after the build "
        f"{sum(v for k, v in phases.items() if k != 'build'):.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        count = COUNT_OF.get(name, name)
        launches = 0 if name in OFF_MAIN_PATH else next(
            (runs[k]["counts"][count] for k in RUN_OF.get(name, (
                "a", "b", "e", "f", "g", "h", "i", "engine", "k", "l", "m", "n", "o", "p", "q",
                "r")) if runs[k]["counts"].get(count)), 0)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches,
            main_path=name not in OFF_MAIN_PATH,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(r["bytes_ms"], r["ops_ms"]),
            bound_by="bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            library_ms=r["library_ms"],
        ))
    # row 19 at GPT-2-small's shapes, M = 8,192 (run (aa): one launch a
    # block each, every call of its counted forward)
    for pname, r in runs["aa"]["rows"].items():
        kernels.append(dict(
            name=f"w8a8_gemm_gpt2_{pname}", route="cuda", source=SOURCES["w8a8_gemm"][0],
            replaces=SOURCES["w8a8_gemm"][1], launches=runs["aa"]["counts"]["w8a8_gemm"] // 4,
            main_path=True, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(r["bytes_ms"], r["ops_ms"]),
            bound_by="bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            library_ms=r["library_ms"],
        ))
    if out_dir is not None:
        _LOG["file"].write(json.dumps({"kernels": kernels, "runs": runs, "phases": phases}) + "\n")
        _LOG["file"].close()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
