"""Drive the PyTorch/CUDA port's serving paths, weight-store tools, CLI,
data-free calibration, serving planner and parallel serving once on one GPU.

    python3 chip_smoke.py            # twenty paths and six zoo members, batches 1, 8, 64

Builds the fourteen CUDA kernels from ``p2vit_tpu_torch/csrc`` (one nvcc per
source, in parallel, sm_90a), then drives twelve int8 serving paths of two
models at full width and depth, with seeded random weights and images, then
the rest of the zoo, then weight-only serving of both models and the two
weight-store GEMM tools:

* DeiT-S (``deit_small_patch16_224``: C=384, 6 heads, 197 tokens): seeded
  init → calibrate (one batch) → convert(W4A8, [4]*50) → serving_forward,
  at the default flags (``deit``), staged (``deit_staged``:
  ``fuse_embed=False, fuse_qkv=False``) and one kernel per encoder layer
  (``deit_layer``: ``fuse_layer=True``);
* DeiT-S LIS off: make_policy(lis=False) → calibrate → convert(W4A8) →
  attach_u8_ingest → serving_forward(lis=False) on uint8 images, fused
  (``deit_lisoff``), staged (``deit_staged_lisoff``) and per layer
  (``deit_layer_lisoff``);
* Swin-T (``swin_tiny_patch4_window7_224``: C=96, depths (2,2,6,2), heads
  (3,6,12,24), 7×7 windows): seeded init → calibrate (one batch) →
  convert(4) → serving_forward at the defaults (``swin``), and the same
  under make_policy(lis=False) on uint8 images (``swin_lisoff``). On the
  same two states, the serving flags: ``swin_fold`` and
  ``swin_fold_lisoff`` (``fold_windows=True``), ``swin_stem``
  (``fuse_stem=True``) and ``swin_int_stem_unfused`` (``int_stem=True,
  fuse_res=False``).
* The zoo (``ZOO``: ``deit_tiny``, ``deit_base``, ``vit_base``,
  ``vit_large``, ``swin_small``, ``swin_base``), each member at full width
  and depth: seeded init → calibrate (``ZOO_CALIB`` = 8 seeded images; LIS
  off: uint8 images normalized on the host by the family's mean and std)
  → convert (W4A8 ``[4]*num_matmuls``, Swin ``convert(4)``) →
  serving_forward on each of its paths: DeiT-T default, staged, fused layer
  (bitwise against default) and LIS off on uint8; DeiT-B default and staged;
  ViT-B default, LIS off default and staged on uint8 at the vit family's
  mean = std = 0.5; ViT-L (depth 24) default, staged and LIS off on uint8;
  Swin-S default and ``fold_windows`` (bitwise against default); Swin-B
  default, ``fold_windows``, ``fuse_stem`` and LIS off on uint8. Each path:
  phases 1-4 below at batches 1 and 8 (phase 1 at both), then one profiler
  window at batch 64 (device ms per forward, beside the member's bf16
  ``fp_forward``) and each kernel against its plain version at batch 8
  (the ``per_model`` entries, with ``"batch": 8``). DeiT-B, ViT-B and ViT-L
  are held to ``fuse_layer=True`` raising ValueError naming
  ``fuse_layer=False`` with nothing launched (the fused layer's shared
  memory; JAX's VMEM guard refuses them too). The zoo's seconds on a line
  of their own.
* ``deit_wonly`` / ``swin_wonly``: ``weight_only_params`` of the DeiT-S and
  Swin-T states, requantized on the card to ``convert``'s codes (must be
  bit for bit), cast to bf16 and served by ``fp_forward``: launches of the
  port's kernels (0), argmax agreement with the int8 path and the
  simulation (report), img/s and device ms beside the bf16 forward of the
  unquantized params. ``deit_wonly``'s phase 1 holds ``wstream_matmul`` in
  all four stores against its plain version on blocks 0 and 11's GEMMs,
  with the activations of the weight-only forward (1/cs folded into x) and
  with a draw of the same shapes whose rows span 25 binades.
* ``cli``: the port's CLI (``p2vit_tpu_torch/cli.py``) in process, its own
  steps, on a folder of seeded 256 × 320 PNGs it writes (64 train images,
  two calibration batches of 32; 136 val: batches of 64, 64 and a short 8), decoded by the port's native
  loader where it builds, else PIL (with neither, the CLI's device half
  runs over seeded images: "cli decode: none on this machine"):
  ``deit_small --quant --serve --checkpoint <a .pth of the seeded DeiT-S
  params> --calib-batchsize 32 --val-batchsize 64 --limit-val 3`` saving
  its quant state, then ``--u8-ingest`` on the loaded state, then the
  state reloaded, then ``swin_tiny --quant --serve --random-init``, then
  ``vit_base --quant --serve --random-init`` (the vit family's crop 0.9 and
  mean = std = 0.5, which nothing else runs on the card), then
  ``deit_small ... --calib-iter 2 --quant-method omse`` (a state whose
  activation scales are not powers of two), ``deit_small ... --calib-iter 2
  --mixed --live-hessian --hessian-batches 1 --limit-val 1`` (the
  mixed-precision search: the Hessian's seconds, the front's size, the
  configs validated and seconds per validation split into the wait on the
  decode and the forward, the five best configs, and the best config's
  logits against the plain path, bitwise, with its launch counts) and
  ``swin_tiny ... --calib-iter 2 --quant-method percentile``. Each run: its
  val logits against ``serving_forward`` on the same state and images and
  against its plain path (``use_kernels=False``; must be 0 differing; after
  the reload, against the first run's too), Prec@1/5 against ``accuracy``
  recomputed from the logits, the val loop's launch counts against
  ``launches_per_forward`` × batches, and host ms per val batch split into
  the wait on the prefetch queue and the forward, beside the card's name
  and power limit.
* ``datafree``: the CLI's ``--mode 2`` at DeiT-S width on the folder the
  ``cli`` path writes (``deit_small --quant --serve --mode 2 --checkpoint
  <the seeded .pth> --calib-batchsize 32 --val-batchsize 64 --limit-val
  3``): ``datafree.generate_data``'s 2 × 500 Adam steps at batch 32, timed
  (seconds, steps per second, peak memory, the three loss terms at the first
  and last step), then the run held as the ``cli`` path holds its runs
  (logits bitwise against ``serving_forward`` and its plain path, launch
  counts); Swin-T's ``generate_data(iterations_per_epoch=25)`` called
  directly (2 × 25 steps, a cut from 2 × 500 that keeps the script inside
  its time limit), calibrated, converted (W4) and served at batch 64,
  bitwise against its plain path, with its launch counts; and ``--plot`` at
  DeiT-S: ``collect_activations`` on the card against the same call on the
  CPU (1e-4 relative a tensor), the SVGs written only where matplotlib
  imports (else one line says it is absent).
* ``plan``: the port's ``tools/latency_ab.py`` sweep at DeiT-T, DeiT-S and
  Swin-T, batches 1, 8, 32, 64, 128, 256 (``PLAN_ITERS`` forwards a
  timing window): the table in ms per forward (CUDA events), device ms
  (profiler) and img/s; at each (model, batch) every int8 arm's logits
  bitwise against its plain path, its launches of one forward against
  ``launches_per_forward`` and the fused layer bitwise against the default,
  and every ViT int8 arm again at batch 256 on a calibrated W8 state (any
  difference fails); and for each (model, batch) whether
  ``plan.recommend(prefer_exact=False)`` names the arm measured fastest (a
  disagreement is printed, not failed).
* ``parallel``: the LIS-on DeiT-S (W4A8 ``[4]*50``) and Swin-T (W4)
  states to a file, then ``PAR_WORLD`` = 3 ranks of one gloo group on this
  card (``parallel.dist.run_ranks``; the kernels built once, in this
  process): DeiT-S ``dp=2``, ``tp=2`` and ``tp=3`` with the qkv-fused
  attention and with the qkv GEMM then ``lis_attention_fused``, ``tp=2``
  with sequence-parallel epilogues, ``pp=2`` at 2 and 4 microbatches on
  the fused layer, and Swin-T ``tp=3``, each at batch 64 and then 61 (pad
  and trim). Each scenario's logits must equal this process's
  ``serving_forward`` on the same state and requests bit for bit; on rank
  0 the kernels at the shard's shapes (rows 3, 8 and 1's fc1 at heads/tp
  and hid/tp, row 7 at the local heads, row 12 on a stage's layers, each
  first call at each shape) against their plain versions, 0 mismatches;
  every rank's launches against the shard's prediction; ms per forward on
  rank 0 (CUDA events) and the share in host-staged collectives, labelled
  as ranks time-sliced on one card. The ``cli`` path also runs ``main``
  with ``--tp 2`` on its saved state: Prec@1/5 equal to one process's.
  Then the three mesh surfaces of the fake-quant and float programs
  (``parallel.dryrun.ENVELOPES``, no kernel runs) on the same
  ``PAR_WORLD`` ranks at the dry run's tiny ViT and a batch of 6:
  ``vit.calibrate`` on the batch sharded 3 × 1 (decisions bit for bit), DP×TP
  of ``quant_forward`` over 1 × 2 (within one LSB of act_out's grid, argmax
  equal) and the DP data-free generation gradient over 3 × 1 (rtol 2e-4,
  atol 2e-6); one parity line each.
* Before the paths: each shape JAX serves that the kernels once refused
  (``tools/shape_faults.py``: the fused layer at C = 32 and 96; N = 257, 300 and 577 in the three ViT attention
  kernels and N = 257 and 300 in the fused layer; the qkv-fused kernel at
  head_dims 32 and 128 and C_in = 200; head_dim 128 in the per-item kernels
  and the fused layer; both Swin attention entries at head_dim 64 with
  N = 49 and at N = 256, with the shift mask; the stem at C = 1536 and
  4096), LIS on and off, through ``tools/shape_faults.check``: the kernel
  against its plain version (0 mismatches), one counted launch a call and
  device time in the kernel's symbol; one line per shape with its µs per
  call (CUDA events, the padding included), its device µs and the kernel's
  share of them (``torch.profiler``) and its bound, beside the card's name
  and power limit.
* With ``swin``, before the paths: both Swin attention entries at 12×12
  windows (N = 144, the kernel's unstaged instance), LIS on and off, the
  panel one with and without the shift mask and the folded one at shift 0
  and 6, at head_dims 32 and 16, against their plain versions (0
  mismatches), with the instance's launch facts and µs per call.
* With ``swin_stem``, before the paths: ``fused_swin_stem`` past C = 256,
  at C = 384 and at ``MAX_STEM_C`` (clusters of 2 and 4 CTAs), on
  random-normal inputs and a calibrated state's kinds, against its plain
  version (0 mismatches), with its launch facts and ms per call.
* ``w4pack`` / ``wstream``: the ported tools (``p2vit_tpu_torch/tools``) at
  the DeiT-S GEMMs, M = 197·batch, depth 12. Phase 1: ``int4_matmul_requant``
  against its plain version and the int8 kernel (also on the ``deit``
  path's fc1 and head arguments, packed, and on forced grids: one CTA, three,
  one tile a CTA), ``wstream_matmul`` in each store
  against its plain version (also on x rows spanning 25 binades); phase
  2/3: one depth-12 chain per arm and M, 4·12 launches each; phase 5: the
  tools' lines (ms per GEMM and chain) and each kernel's ms against its
  plain version, its bound and, for ``wstream_matmul``, the bf16
  ``torch.matmul`` over the same codes, its TFLOP/s and share of the float64
  tensor-core peak (fc1 at M = 12608, and per chain), and its blocks at
  M = 197; ``int4_matmul_requant``'s launch line per GEMM (the packed plan:
  tile width, consumers, ring stages, grid; shared memory, registers,
  spills, CTAs per SM) and, per M, both stores' chains in device ms beside
  their bounds. After the paths (``cuobjdump`` runs beside them from the
  build on), the DMMA instructions in the built
  ``wstream_matmul`` kernels, the IMMA instructions in the cluster
  attention kernel and in the Swin attention kernel, and the warpgroup-MMA
  (IGMMA) and TMA-load (UTMALDG)
  instructions in the Hopper ``int8_matmul_requant``, ``int8_matmul_res_ln``,
  ``fused_patch_embed`` and ``fused_vit_layer`` kernels and, on their own,
  the int4-store instances of the requant kernel, the IMMA
  instructions of the fused layer and of the per-item attention kernel, and
  the shared loads (LDS) against the
  multiplies of ``fused_swin_stem``'s inner loop (``cuobjdump -sass``,
  report only), and
  the int-LN kernels' two chain rewrites against ``ln_elem`` over all 2^32
  float32 inputs (mismatches; must be 0).

Before the paths, when ``swin`` runs: the JAX tests' TINY Swin (head_dims
8 and 16, zero-padded to the kernels' 32 by the wrappers), LIS on and off:
both Swin attention entries against their plain versions on its captured
arguments, and its ``serving_forward`` against the plain path (0 mismatches).

Phases of the int8 serving paths, one line each, per path:

  1. each kernel of the path against its plain PyTorch version, on the card,
     on the arguments the path gives it (captured from a plain forward at
     batch 8 and 64): mismatch counts; must be 0. The staged path also holds
     ``lis_attention`` against its plain version, on the captured qkv codes
     split to (B·H, N, 64), and both per-item attention kernels on the same
     codes read at head_dims 32 and 16 and, at batch 8, at 8, 4, 2 and 1,
     and on forced query-group chunks; the fused-layer paths hold
     ``fused_vit_layer`` on forced plans (7 CTAs; 1 and 4 query groups a
     chunk; blocks of 32 and 64 rows) and at head_dim 32 and, at batch 8,
     at 8, 4, 2 and 1; the Swin paths hold the Swin attention on each
     panel call's arguments on forced grids (one item per CTA, 7 CTAs) and
     the folded entry, at shift 0 and ws // 2, on the raster grid the
     panels tile. The prologue kernels are also held on forced plans:
     ``fused_patch_embed`` on every cluster size and consumer count that
     fits and on the same patches as float32 values (its in-kernel
     quantize), and its PTF divide against ``__fdiv_rn`` over all 2^32
     dividends for each s_qact1 value of the state; ``fused_swin_stem`` on
     one block a CTA and on 7 CTAs.
  2. the path: launch counts reset, serving_forward through the kernels on
     every request batch, counts read. Its logits must equal the plain
     path's (``use_kernels=False``) bit for bit. uint8 paths: the logits must
     equal those of the same images normalized on the host (numpy float32,
     the literal sequence), and ``u8_ingest_exact`` must hold for the
     literal form (the fused affine form is reported). Flag paths: the
     logits against the default path's on the same state and requests,
     which ``fuse_layer`` (against ``deit`` / ``deit_lisoff``) and
     ``fold_windows`` must equal bit for bit, and ``fuse_stem`` too unless
     s_bn is not a power of two; the int stem with unfused junctions is
     reported (rel error, argmax agreement).
  3. the launch counts of that run: the path's per-forward counts
     (``serving.launches_per_forward``, ``serving_swin.launches_per_forward``
     with the path's flags) and 0 for every other kernel.
  4. logits finite, of shape (B, 1000); relative error, share of equal
     logits and argmax agreement against the fake-quant simulation, and the
     number of distinct predicted classes (reported, not checked).
  5. timing with CUDA events after warm-up: img/s at the largest batch for
     serving with kernels, the plain path, a bf16 ``fp_forward`` (default
     paths) and float32 input (uint8 paths); the device ms per forward from
     ``torch.profiler`` (the port's kernels and the other PyTorch kernels);
     each kernel against its plain version at that batch's shapes, beside
     its bound (the larger of its bytes over 3.35 TB/s and its products over
     the int8, float32 or bf16 peak). Then staged against fused, LIS off against
     LIS on, uint8 against float32, and each Swin-T flag path against the
     default, each on one line; ``deit_layer`` against ``deit`` at every
     batch (img/s, device ms, the other PyTorch kernels' and the idle
     share). The fused layer's phase 5 lines also split one call into its
     qkv GEMM, attention and row-block phases (block 0's clock) and give
     its launch (threads, grid, shared memory per phase, query groups a
     chunk, registers, spills, CTAs per SM); the per-item attention
     kernels' lines give theirs (padded head_dim, groups a chunk, shared
     memory, registers, spills, CTAs per SM); the
     qkv-fused attention's line gives its cluster launch (registers, shared
     memory per CTA, CTAs per SM, resident clusters), the five phases of
     one CTA in the middle of the launch and its ms per forward beside the
     staged pair on the same arguments (the qkv ``int8_matmul_requant``
     then ``lis_attention_fused``). A path that runs ``int8_matmul_requant``
     prints its device ms per forward summed over all the kernel's
     instances (one per tile width), and each of its shapes a launch line: its plan (tile width BN, consumer warpgroups,
     ring stages, tiles, persistent grid), shared memory, registers at
     launch and per consumer after ``setmaxnreg``, spill bytes and CTAs per
     SM from the CUDA runtime, its time on one tile per CTA (no persistent
     ring), and ``torch._int_mm``'s time for the int32 product alone (a
     reference: not the same function, so ``library_ms`` stays null). A path
     that runs ``int8_matmul_res_ln`` does the same for the junction: its
     device ms per forward over all its instances, and per shape a launch
     line (CTAs per cluster, chunk width BN and chunks per CTA, consumer
     warpgroups, ring stages, row blocks, persistent grid, resident
     clusters, shared memory, registers, spill bytes, CTAs per SM;
     ``torch._int_mm`` beside it). A path that runs the Swin attention does
     the same for it: its device ms per forward over all instances, the
     device ms in ``roll`` kernels, and per shape a launch line (items,
     grid, CTAs per SM, shared memory, registers, spills, its time at one
     item per CTA, the middle CTA's phase clock and bias stagings, and the
     spread of the CTAs' durations). A path that runs the int-LN kernels
     does the same for each: its device ms per forward over its instances,
     and per shape a launch line (lanes per row G, chunks per lane, rows per
     CTA block, blocks, grid, CTAs per SM, shared memory, registers, spill
     bytes). A path that runs a prologue kernel does the same: its device ms
     per forward, and a launch line (the plan: the embed's clusters, chunks,
     consumers, stages, row blocks and grid, the stem's channels a thread,
     blocks, grid and shared loads a product; registers, spills; device µs
     of the call and of the kernel alone against its bound, the stem's also
     against its multiply-and-add ceiling).

Then the card's name and power limit, one JSON line of per-kernel results
(``launches`` summed over the paths' phase-2 runs, ``ms``/``plain_ms``/
``bound_ms`` per forward at the largest batch summed over the paths that run
the kernel, for the weight-store kernels per chain; ``library_ms`` for
``wstream_matmul``; ``redesigned`` the Hopper design of a kernel redesigned
after its first port, or null; ``per_model`` the breakdown by path), and last ``{"ok": true,
"device": {...}}``. Any failure raises (exit 1, no result line). There is no
CPU path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the kernels redesigned for Hopper after their first port, and the design they took
REDESIGNED = {"wstream_matmul": "float64 tensor cores (mma.sync.m16n8k16) on exact panel sums",
              "lis_attention_qkv_fused": "4-CTA cluster, K/V through distributed shared memory, int8 mma.sync",
              "int8_matmul_requant": "TMA ring, int8 wgmma on N-sized tiles, persistent warp-specialized grid",
              "int8_matmul_res_ln": "TMA ring, int8 wgmma chunks into a whole-row code tile, clusters splitting N",
              "swin_lis_attention": "persistent grid taking items from a counter, q/k/v and mask by cp.async, "
                                    "bias per head change, int8 mma.sync scores and LIS attn@v",
              "swin_lis_attention_folded": "the same body; window partition, reverse and the cyclic shift "
                                           "in its addresses",
              "int_ln_requant": "G lanes a row sized to C, 16-byte chunks held in registers, vectors in shared "
                                "memory, persistent grid, exact float/int32 lane sums",
              "int_res_ln_requant": "the same body; the residual code computed once and kept for the LN pass",
              "fused_patch_embed": "TMA ring, int8 wgmma chunks into a whole-row code tile, clusters splitting C, "
                                   "[CLS] rows once per CTA, a Markstein-corrected PTF divide, 16-byte LN pass",
              "fused_swin_stem": "4 rows × C/16 channels a thread in registers, summed in k order; cp.async "
                                 "double buffer, persistent grid, exact lane sums; past C = 256 clusters of "
                                 "⌈C/256⌉ CTAs split C and add their row sums through distributed shared memory",
              "fused_vit_layer": "one cooperative launch, 384 threads an SM: qkv GEMM and the 64-row MLP chain on "
                                 "a TMA ring and int8 wgmma chunks, MLP input and GELU codes in swizzled shared "
                                 "tiles; attention on the per-item mma.sync body, the next item prefetched",
              "lis_attention_fused": "per-item body: q/k/v by cp.async, keys and head_dim zero-padded, int8 "
                                     "mma.sync scores and LIS attn@v over hi/lo planes, query groups in chunks",
              "lis_attention": "the same body over split q/k/v, any head_dim up to 64",
              "int4_matmul_requant": "the int8 store's body (TMA ring, int8 wgmma, persistent warp-specialized "
                                     "grid) on boxes of the packed store, unpacked chunk to chunk in shared memory "
                                     "by the producer warpgroup's idle warps"}
# kernel → (plain version's module, its name, CUDA source, the TPU kernel it replaces)
SOURCES = {
    "fused_patch_embed": ("embed_fused", "fused_patch_embed_plain", "embed_fused.cu",
                          "p2vit_tpu/ops/embed_fused.py:92"),
    "lis_attention_qkv_fused": ("attention_lis", "lis_attention_qkv_fused_plain", "attention_lis.cu",
                                "p2vit_tpu/ops/attention_lis.py:387"),
    "int8_matmul_res_ln": ("matmul_ln", "int8_matmul_res_ln_plain", "matmul_ln.cu",
                           "p2vit_tpu/ops/matmul_ln.py:90"),
    "int8_matmul_requant": ("matmul_int8", "int8_matmul_requant_plain", "matmul_int8.cu",
                            "p2vit_tpu/ops/matmul_int8.py:117"),
    "int_ln_requant": ("intln", "int_ln_requant_plain", "intln.cu", "p2vit_tpu/ops/intln.py:98"),
    "int_res_ln_requant": ("intln", "int_res_ln_requant_plain", "intln.cu",
                           "p2vit_tpu/ops/intln.py:187"),
    "swin_lis_attention": ("attention_lis", "swin_lis_attention_plain", "swin_attention.cu",
                           "p2vit_tpu/ops/attention_lis.py:596"),
    "lis_attention_fused": ("attention_lis", "lis_attention_fused_plain", "attention_lis.cu",
                            "p2vit_tpu/ops/attention_lis.py:228"),
    "lis_attention": ("attention_lis", "lis_attention_plain", "attention_lis.cu",
                      "p2vit_tpu/ops/attention_lis.py:143"),
    "fused_swin_stem": ("swin_stem", "fused_swin_stem_plain", "swin_stem.cu",
                        "p2vit_tpu/ops/swin_stem.py:60"),
    "swin_lis_attention_folded": ("attention_lis", "swin_lis_attention_folded_plain",
                                  "swin_attention.cu", "p2vit_tpu/ops/attention_lis.py:693"),
    "fused_vit_layer": ("layer_fused", "fused_vit_layer_plain", "layer_fused.cu",
                        "p2vit_tpu/ops/layer_fused.py:125"),
    "int4_matmul_requant": ("matmul_int8", "int4_matmul_requant_plain", "matmul_int8.cu",
                            "p2vit_tpu/ops/matmul_int8.py:256"),
    "wstream_matmul": ("matmul_wstream", "wstream_matmul_plain", "matmul_wstream.cu",
                       "p2vit_tpu/ops/matmul_wstream.py:174"),
}
# The rest of the zoo, each member's paths at batches 1 and 8 and one profiler window at 64:
# --models key → (zoo config, name, preprocessing family, LIS-on paths, LIS-off paths on uint8 images).
# ViT paths are DEIT_FLAGS keys, Swin paths SWIN_FLAGS keys; a ViT member without "_layer" is held
# to fuse_layer=True raising (the fused layer's shared memory, as JAX's VMEM guard refuses it).
ZOO = {"deit_tiny": ("deit_tiny_patch16_224", "DeiT-T", "deit", ("", "_staged", "_layer"), ("",)),
       "deit_base": ("deit_base_patch16_224", "DeiT-B", "deit", ("", "_staged"), ()),
       "vit_base": ("vit_base_patch16_224", "ViT-B", "vit", ("",), ("", "_staged")),
       "vit_large": ("vit_large_patch16_224", "ViT-L", "vit", ("", "_staged"), ("",)),
       "swin_small": ("swin_small_patch4_window7_224", "Swin-S", "swin", ("swin", "swin_fold"), ()),
       "swin_base": ("swin_base_patch4_window7_224", "Swin-B", "swin", ("swin", "swin_fold", "swin_stem"),
                     ("swin_lisoff",))}
ZOO_CALIB, ZOO_BATCHES, ZOO_WINDOW = 8, (1, 8), 64  # calibration images; phase 1-2 batches; profiler batch
PATHS = ("deit", "deit_staged", "deit_layer", "deit_lisoff", "deit_staged_lisoff", "deit_layer_lisoff",
         "swin", "swin_lisoff", "swin_fold", "swin_fold_lisoff", "swin_stem", "swin_int_stem_unfused",
         "deit_wonly", "swin_wonly", "w4pack", "wstream", "cli", "datafree", "plan", "parallel") + tuple(ZOO)
PLAN_BATCHES = (1, 8, 32, 64, 128, 256)  # the plan path's sweep
PLAN_ITERS = 10  # forwards a timing window there (latency_ab's default windows, up to 200, take ~10 min)
# DeiT-S paths by key suffix: (display name suffix, serving flags)
DEIT_FLAGS = {"": ("", dict(fuse_embed=True, fuse_qkv=True)),
              "_staged": (" staged", dict(fuse_embed=False, fuse_qkv=False)),
              "_layer": (" fused layer", dict(fuse_layer=True))}
# Swin-T paths beyond the defaults: (LIS on, serving flags, check against the
# default path on the same state and requests: "bitwise", "stem" (bitwise
# unless s_bn is not a power of two) or "report")
SWIN_FLAGS = {"swin": (True, {}, None), "swin_lisoff": (False, {}, None),
              "swin_fold": (True, dict(fold_windows=True), "bitwise"),
              "swin_fold_lisoff": (False, dict(fold_windows=True), "bitwise"),
              "swin_stem": (True, dict(fuse_stem=True), "stem"),
              "swin_int_stem_unfused": (True, dict(int_stem=True, fuse_res=False), "report")}
SWIN_NAMES = {"swin": "", "swin_lisoff": " LIS-off", "swin_fold": " fold", "swin_fold_lisoff": " fold LIS-off",
              "swin_stem": " fused stem", "swin_int_stem_unfused": " int stem unfused"}  # after the model's name
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense)
HBM_BYTES_S, INT8_OPS_S, F32_FLOPS_S, BF16_FLOPS_S = 3.35e12, 1979e12, 67e12, 989e12
F64_TC_FLOPS_S = 67e12  # float64 tensor cores (DMMA), the ceiling of wstream_matmul's exact sums
WIDE_SPAN = 25  # binades spanned by each row of the wide-span draw (the numerics contract's limit)

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int):
    """Device time per call from ``torch.profiler`` after one warm-up: (all
    device kernels, the port's kernels, {kernel name: ms}), in ms; (None,
    None, {}) if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    if not by_name:
        return None, None, {}
    port = sum(v for k, v in by_name.items() if "anonymous namespace" in k or "p2v::" in k)  # the csrc kernels
    return sum(by_name.values()), port, by_name


def _ops(name, a):
    """(operations, peak op/s) of one call: the kernel's products, counted
    as the int8 (for the stem float32, for wstream bf16) operations they
    are; the epilogues' and the softmax's elementwise work is left out."""
    if name in ("int8_matmul_requant", "int8_matmul_res_ln", "int4_matmul_requant"):
        (m, k), n = a[0].shape, a[1].shape[0]
        return 2 * m * n * k, INT8_OPS_S
    if name == "wstream_matmul":
        (m, k), n = a[0].shape, a[2].shape[0]
        return 2 * m * n * k, BF16_FLOPS_S
    if name == "fused_patch_embed":
        (b, np_, k), c = a[0].shape, a[1].shape[0]
        return 2 * b * np_ * k * c, INT8_OPS_S
    if name == "fused_swin_stem":
        (m, k), c = a[0].shape, a[1].shape[0]
        return 2 * m * k * c, F32_FLOPS_S
    if name == "lis_attention_qkv_fused":
        (b, n, c_in), c3 = a[0].shape, a[1].shape[0]
        return 2 * b * n * c_in * c3 + 4 * b * n * n * (c3 // 3), INT8_OPS_S
    if name == "lis_attention_fused":
        b, n, c3 = a[0].shape
        return 4 * b * n * n * (c3 // 3), INT8_OPS_S
    if name == "lis_attention":
        bh, n, d = a[0].shape
        return 4 * bh * n * n * d, INT8_OPS_S
    if name == "swin_lis_attention":
        w, n, c3 = a[0].shape
        return 4 * w * n * n * (c3 // 3), INT8_OPS_S
    if name == "swin_lis_attention_folded":
        b, res, _, c3 = a[0].shape
        n = a[4] * a[4]
        return 4 * b * res * res * n * (c3 // 3), INT8_OPS_S
    if name == "fused_vit_layer":
        (b, n, c), hid = a[0].shape, a[19].shape[0]
        return 2 * b * n * c * (3 * c + c) + 2 * b * n * c * hid * 2 + 4 * b * n * n * c, INT8_OPS_S
    return 0, INT8_OPS_S  # the int-LN kernels: elementwise only


def _bound(name, a, outs):
    """(ms, "bytes" or "operations"): the least time the card could take
    for one call, the larger of its bytes (each tensor input read once, each
    output written once) over the HBM rate and its operations over their
    peak."""
    nbytes = sum(t.numel() * t.element_size() for t in list(a) + list(outs)
                 if isinstance(t, torch.Tensor))
    ops, peak = _ops(name, a)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _is_pot(t) -> bool:
    mant, _ = torch.frexp(torch.as_tensor(t, dtype=torch.float32))
    return bool((mant.abs() == 0.5).all())


def _capture(modules, names, run):
    """Run ``run()`` with each ``module.name`` function wrapped to record its
    calls' arguments; returns {name: [(args, kwargs), ...]}. A kernel
    wrapper counts its launches on the module attribute it is looked up
    by, so its recorder carries a ``launches`` count of its own, added back
    to the wrapper's on restore."""
    calls = {n: [] for n in names}
    saved = []
    for mod, n in zip(modules, names):
        fn = getattr(mod, n)

        def rec(*a, _fn=fn, _n=n, **k):
            calls[_n].append((a, k))
            return _fn(*a, **k)

        if hasattr(fn, "launches"):
            rec.launches = 0
        saved.append((mod, n, fn, rec))
        setattr(mod, n, rec)
    try:
        run()
    finally:
        for mod, n, fn, rec in saved:
            setattr(mod, n, fn)
            if hasattr(fn, "launches"):
                fn.launches += rec.launches
    return calls


def _cast_tree(tree, dtype):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _shape_key(a, k):
    return tuple(t.shape if isinstance(t, torch.Tensor) else t is None for t in a) + (bool(k.get("gelu")),)


def host_normalize(u8: torch.Tensor, mean=MEAN, std=STD) -> torch.Tensor:
    """uint8 images → (u/255 − mean)/std in float32 on the host (numpy), the
    op sequence of the data pipeline, then back to the images' device."""
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)
    x = (u8.cpu().numpy().astype(np.float32) / np.float32(255.0) - mean) / std
    return torch.from_numpy(x).to(u8.device)


@dataclasses.dataclass
class Path:
    """One serving path as chip_smoke drives it."""

    name: str
    key: str  # the path's name in --models
    kernels: tuple  # kernel names the path runs
    per_forward: dict  # expected launches per forward
    forward: object  # (x, use_kernels) -> logits
    simulate: object  # float32 x -> fake-quant logits
    bf16: object  # float32 x -> bf16 fp logits, or None
    num_classes: int
    img_size: int
    u8_state: dict | None = None  # the serving state of a uint8 path
    split_check: bool = False  # hold lis_attention on lis_attention_fused's arguments
    base: object = None  # (x, use_kernels) -> the default flags' logits on the same state
    base_name: str | None = None  # that default path's name
    base_key: str | None = None  # and its key
    vs_base: str | None = None  # "bitwise", "stem" or "report" (SWIN_FLAGS; fuse_layer bitwise)
    s_bn: object = None  # the state's patch_qact_bn scale ("stem")
    mean: tuple = MEAN  # the host pipeline's normalization of a uint8 path
    std: tuple = STD


def _split_calls(calls):
    """lis_attention_fused_plain's captured calls → lis_attention arguments:
    the (B, N, 3C) qkv codes split to contiguous (B·H, N, 64) q, k, v."""
    out = []
    for a, k in calls:
        qkv, heads = a[0], a[1]
        b, n, c3 = qkv.shape
        parts = qkv.reshape(b, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
        q, kk, v = (parts[i].reshape(b * heads, n, -1).contiguous() for i in range(3))
        out.append(((q, kk, v) + tuple(a[2:]), k))
    return out


def run_path(path: Path, batches, reps, img, ops, counts_api, window=None):
    """Phases 1–5 of one path; returns ({kernel: launches, max error, ms and
    plain ms}, {"ms": ms/forward at the largest batch, "f32_ms": the same on
    float32 input}).

    ``window``, a batch, makes it the zoo form: phase 1 at every batch of
    ``batches``, and in place of phase 5's timings and launch lines one
    profiler window at batch ``window`` (device ms per forward, beside the
    bf16 forward's) and each kernel against its plain version at the
    largest of ``batches`` (the results' ``batch``)."""
    reset_launch_counts, launch_counts = counts_api
    u8 = path.u8_state is not None
    requests = {b: img(b, path.img_size, u8) for b in batches}
    bt = max(batches)
    norm = lambda x: host_normalize(x, path.mean, path.std)  # noqa: E731
    plain = {n: (getattr(ops, SOURCES[n][0]), SOURCES[n][1], getattr(ops, n)) for n in path.kernels}
    mods = [v[0] for v in plain.values()]
    pnames = [v[1] for v in plain.values()]
    if path.split_check:
        plain["lis_attention"] = (ops.attention_lis, "lis_attention_plain", ops.lis_attention)

    # ---- phase 1: each kernel vs its plain version on the path's arguments --
    worst = {k: 0 for k in plain}
    mismatches = {k: 0 for k in plain}
    swin_entries = {}  # the Swin kernel's forced grids and shifted folded entry, kernel vs plain
    prologue = {}  # the prologue kernels' forced plans (and the embed's divide), kernel vs plain
    timing_calls = {}
    for b in sorted(batches) if window else sorted({8, bt}):
        x = requests[b] if b in requests else img(b, path.img_size, u8)
        calls = _capture(mods, pnames, lambda: path.forward(x, False))
        if path.split_check:
            calls["lis_attention_plain"] = _split_calls(calls["lis_attention_fused_plain"])
        for name, (mod, pname, kern) in plain.items():
            seen = {}
            for a, k in calls[pname]:
                seen.setdefault(_shape_key(a, k), (a, k))
            for key, (a, k) in seen.items():
                got = _as_tuple(kern(*a, **k))
                want = _as_tuple(getattr(mod, pname)(*a, **k))
                for g_, w_ in zip(got, want):
                    diff = (g_.to(torch.int32) - w_.to(torch.int32)).abs()
                    mismatches[name] += int((diff != 0).sum())
                    worst[name] = max(worst[name], int(diff.max()))
                if name == "swin_lis_attention":
                    for key2, n_bad in _swin_entry_checks(ops, a, k).items():
                        swin_entries[key2] = swin_entries.get(key2, 0) + n_bad
                if name in ("fused_patch_embed", "fused_swin_stem"):
                    for key2, n_bad in _prologue_checks(ops, name, a, k, want).items():
                        prologue[key2] = prologue.get(key2, 0) + n_bad
                if name in ("fused_vit_layer", "lis_attention_fused", "lis_attention"):
                    for key2, n_bad in _vit_plan_checks(ops, name, a, k, want).items():
                        prologue[key2] = prologue.get(key2, 0) + n_bad
                if b == bt:
                    count = sum(1 for a2, k2 in calls[pname] if _shape_key(a2, k2) == key)
                    timing_calls.setdefault(name, []).append((a, k, count, _bound(name, a, want)))
    torch.cuda.synchronize()
    print(f"{path.name} phase 1 kernels vs plain (batches {sorted(batches) if window else sorted({8, bt})}, path "
          f"arguments): "
          f"mismatches {json.dumps(mismatches)}", flush=True)
    if any(mismatches.values()):
        _fail(f"{path.name}: kernel disagrees with its plain version: {mismatches}")
    if prologue:
        print(f"{path.name} phase 1 kernels on forced plans and other head_dims (the path's arguments; the embed "
              f"also on float32 patches, and its PTF divide over all 2^32 dividends per s_qact1 value): mismatches "
              f"{json.dumps(prologue)}", flush=True)
        if any(prologue.values()):
            _fail(f"{path.name}: a kernel's forced plan disagrees with its plain version: {prologue}")
    if swin_entries:
        print(f"{path.name} phase 1 Swin attention on the panel calls' arguments (forced grids; the folded "
              f"entry on the raster grid the windows tile, shift 0 and ws // 2): mismatches "
              f"{json.dumps(swin_entries)}", flush=True)
        if any(swin_entries.values()):
            _fail(f"{path.name}: a Swin attention entry disagrees with its plain version: {swin_entries}")

    # ---- phase 2: the path through the kernels ----------------------------
    reset_launch_counts()
    logits = {b: path.forward(x, True) for b, x in requests.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    ref = {b: path.forward(x, False) for b, x in requests.items()}
    neq = {b: int((logits[b] != ref[b]).sum()) for b in batches}
    print(f"{path.name} phase 2 batches {batches}: logits != plain path: {json.dumps(neq)}", flush=True)
    if any(neq.values()):
        _fail(f"{path.name}: serving logits differ from the plain path: {neq}")
    if path.base is not None:
        base = {b: path.base(x, True) for b, x in requests.items()}
        neq = {b: int((logits[b] != base[b]).sum()) for b in batches}
        rel = {b: float((logits[b] - base[b]).norm() / base[b].norm().clamp_min(1e-9)) for b in batches}
        agree = {b: float((logits[b].argmax(1) == base[b].argmax(1)).float().mean()) for b in batches}
        print(f"{path.name} phase 2 against {path.base_name} on the same requests: logits != "
              f"{json.dumps(neq)}, rel {json.dumps(rel)}, argmax agreement {json.dumps(agree)}",
              flush=True)
        if path.vs_base == "stem" and any(neq.values()):
            pot = _is_pot(path.s_bn)
            print(f"{path.name} phase 2: the fused stem moved {sum(neq.values())} logits; s_bn is "
                  f"{'' if pot else 'not '}a power of two", flush=True)
            if pot:
                _fail(f"{path.name}: fused stem differs from the fp stem at a power-of-two s_bn")
        if path.vs_base == "bitwise" and any(neq.values()):
            _fail(f"{path.name}: logits differ from {path.base_name}'s: {neq}")
    if u8:
        from p2vit_tpu_torch import serving

        exact = serving.u8_ingest_exact(path.u8_state)
        affine = (serving.u8_ingest_exact(path.u8_state, affine=True) if "lut" in path.u8_state["u8"]
                  else "n/a (no input codes)")
        neq = {b: int((logits[b] != path.forward(norm(x), True)).sum())
               for b, x in requests.items()}
        print(f"{path.name} phase 2 u8_ingest_exact: exact {exact}, affine {affine}; uint8 logits "
              f"!= host-normalized float32 logits: {json.dumps(neq)}", flush=True)
        if not exact or any(neq.values()):
            _fail(f"{path.name}: uint8 ingest is not exact on this card ({exact}) or its logits "
                  f"differ from float32 ingest: {neq}")

    # ---- phase 3: every kernel of the path ran, as often as it should ------
    nb = len(batches)
    want = {k: nb * path.per_forward.get(k, 0) for k in counts}
    print(f"{path.name} phase 3 launches over {nb} forwards: {json.dumps(counts)} "
          f"(per forward expected {json.dumps(path.per_forward)})", flush=True)
    if counts != want:
        _fail(f"{path.name}: launch counts {counts} != {want}")

    # ---- phase 4: output sanity and the simulation envelope ---------------
    for b, lg in logits.items():
        if tuple(lg.shape) != (b, path.num_classes) or not bool(torch.isfinite(lg).all()):
            _fail(f"{path.name} batch {b}: logits shape {tuple(lg.shape)} or non-finite values")
        sim = path.simulate(norm(requests[b]) if u8 else requests[b])
        rel = float((lg - sim).norm() / sim.norm().clamp_min(1e-9))
        same = float((lg == sim).float().mean())
        agree = float((lg.argmax(1) == sim.argmax(1)).float().mean())
        print(f"{path.name} phase 4 batch {b}: logits finite {tuple(lg.shape)}, |logits| mean "
              f"{float(lg.abs().mean()):.6g}, {len(set(lg.argmax(1).tolist()))} distinct classes; "
              f"vs quant_forward rel {rel:.6g}, equal {same:.4f}, argmax agreement {agree:.4f}")

    # ---- phase 5: timing ----------------------------------------------------
    if window:
        summary = _zoo_window(path, window, img, norm)
    else:
        x = requests[bt]
        xf = norm(x) if u8 else x
        runs = [("int8 kernels", lambda: path.forward(x, True)),
                ("int8 plain", lambda: path.forward(x, False))]
        if path.bf16 is not None:
            runs.append(("bf16 fp_forward", lambda: path.bf16(xf)))
        if u8:
            runs.append(("int8 kernels, float32 input", lambda: path.forward(xf, True)))
        runs.append(("int8 kernels again", lambda: path.forward(x, True)))
        times = {}
        for label, fn in runs:
            with torch.no_grad():
                ms = _time_ms(fn, max(2, reps // 4))
            times[label] = ms
            print(f"{path.name} phase 5 batch {bt} {label}: {ms:.4f} ms/forward, {bt / ms * 1e3:.1f} img/s",
                  flush=True)
        ms = min(times["int8 kernels"], times["int8 kernels again"])
        with torch.no_grad():
            dev_ms, port_ms, by_name = _device_ms(lambda: path.forward(x, True), 5)
        if dev_ms is None:
            print(f"{path.name} phase 5 batch {bt} device ms: not measured (the profiler saw no device time)")
        else:
            print(f"{path.name} phase 5 batch {bt} device ms/forward (profiler): {dev_ms:.4f}, of which "
                  f"the port's kernels {port_ms:.4f} and other PyTorch kernels {dev_ms - port_ms:.4f}",
                  flush=True)
            for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                print(f"{path.name} phase 5 batch {bt} device ms/forward {t:.4f} {name[:110]}")
            for kern, inst in (("int8_matmul_requant", "requant_kernel<"), ("int8_matmul_res_ln", "res_ln_kernel<"),
                               ("swin_lis_attention*", "swin_attention_kernel<"),
                               ("int_ln_requant", r"int_ln_kernel<\d+, false"),
                               ("int_res_ln_requant", r"int_ln_kernel<\d+, true"),
                               ("fused_patch_embed", "embed_kernel<"), ("fused_swin_stem", "swin_stem_kernel<")):
                if kern.rstrip("*") in path.kernels:
                    t = sum(v for name, v in by_name.items() if re.search(inst, name))
                    print(f"{path.name} phase 5 batch {bt} device ms/forward {kern}, all its instances: {t:.4f}",
                          flush=True)
            if path.key.startswith("swin"):
                rolls = {name: v for name, v in by_name.items() if re.search(r"\broll", name)}  # not "unrolled_…"
                print(f"{path.name} phase 5 batch {bt} device ms/forward in roll kernels: {sum(rolls.values()):.4f} "
                      f"({len(rolls)} kernel names)", flush=True)
        summary = {"ms": ms, "f32_ms": times.get("int8 kernels, float32 input", ms), "device_ms": dev_ms,
                   "other_ms": None if dev_ms is None else dev_ms - port_ms}
    results = {}
    kreps = max(2, reps // 4) if window else reps
    for name, (mod, pname, kern) in plain.items():
        k_ms = p_ms = 0.0
        by = {"bytes": 0.0, "operations": 0.0}
        for a, k, count, (b_ms, b_by) in timing_calls[name]:
            t_k = _time_ms(lambda: kern(*a, **k), kreps)
            t_p = _time_ms(lambda: getattr(mod, pname)(*a, **k), kreps)
            shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor) and t.dim() >= 2]
            print(f"{path.name} phase 5 kernel {name} {shapes}{' gelu' if k.get('gelu') else ''}: "
                  f"{t_k:.4f} ms vs plain {t_p:.4f} ms per call, bound {b_ms:.6f} ms ({b_by}), "
                  f"x{count} per forward")
            k_ms += t_k * count
            p_ms += t_p * count
            by[b_by] += b_ms * count
            if window:  # the zoo form: no launch lines
                continue
            if name == "fused_vit_layer":
                print(f"{path.name} phase 5 kernel fused_vit_layer phases: {_layer_phases(kern, a, k)}")
                print(f"{path.name} phase 5 kernel fused_vit_layer launch: {_layer_launch_report(ops, a, k)}",
                      flush=True)
            if name in ("lis_attention_fused", "lis_attention"):
                print(f"{path.name} phase 5 kernel {name} launch: {_vit_attention_launch_report(ops, name, a, k)}",
                      flush=True)
            if name == "lis_attention_qkv_fused":
                print(f"{path.name} phase 5 kernel lis_attention_qkv_fused cluster: "
                      f"{_qkv_cluster_report(ops, a, k, count, reps)}", flush=True)
            if name == "int8_matmul_requant":
                print(f"{path.name} phase 5 kernel int8_matmul_requant launch: "
                      f"{_requant_launch_report(ops, a, k, t_k, reps)}", flush=True)
            if name == "int8_matmul_res_ln":
                print(f"{path.name} phase 5 kernel int8_matmul_res_ln launch: "
                      f"{_res_ln_launch_report(ops, a, t_k, reps)}", flush=True)
            if name in ("swin_lis_attention", "swin_lis_attention_folded"):
                print(f"{path.name} phase 5 kernel {name} launch: "
                      f"{_swin_launch_report(ops, name, a, k, t_k, reps)}", flush=True)
            if name in ("int_ln_requant", "int_res_ln_requant"):
                print(f"{path.name} phase 5 kernel {name} launch: {_intln_launch_report(ops, name, a, t_k)}",
                      flush=True)
            if name in ("fused_patch_embed", "fused_swin_stem"):
                print(f"{path.name} phase 5 kernel {name} launch: "
                      f"{_prologue_launch_report(ops, name, a, k, t_k, b_ms)}", flush=True)
            if name == "lis_attention":  # on no path: its device time on the staged path's split qkv
                _, port_ms, _ = _device_ms(lambda: kern(*a, **k), 5)
                dev = "not measured" if port_ms is None else (
                    f"{port_ms:.4f} per call, {port_ms * count:.4f} for the {count} calls of a forward")
                print(f"{path.name} phase 5 kernel lis_attention device ms (profiler, the kernel alone): {dev}",
                      flush=True)
        results[name] = {"launches": counts[name], "max_abs_err": worst[name], "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": by["bytes"] + by["operations"],
                         "bound_by": max(by, key=by.get), **({"batch": bt} if window else {})}
    return results, summary


def _zoo_window(path, window, img, norm) -> dict:
    """The zoo form of phase 5's forward timings: one profiler window of 5
    forwards at batch ``window`` (device ms per forward, the port's kernels,
    the other PyTorch kernels and the largest kernels), the bf16
    ``fp_forward``'s beside it."""
    u8 = path.u8_state is not None
    x = img(window, path.img_size, u8)
    with torch.no_grad():
        dev_ms, port_ms, by_name = _device_ms(lambda: path.forward(x, True), 5)
        bf16_ms = None if path.bf16 is None else _device_ms(lambda: path.bf16(norm(x) if u8 else x), 5)[0]
    if dev_ms is None:
        print(f"{path.name} batch {window} device ms/forward: not measured (the profiler saw no device time)")
    else:
        top = ", ".join(f"{t:.4f} {name[:60]}" for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
        print(f"{path.name} batch {window} device ms/forward (profiler, 5 forwards): {dev_ms:.4f}, of which the "
              f"port's kernels {port_ms:.4f} and other PyTorch kernels {dev_ms - port_ms:.4f}; bf16 fp_forward "
              f"{'not run on this path' if path.bf16 is None else f'{bf16_ms:.4f}' if bf16_ms else 'not measured'}; "
              f"largest: {top}", flush=True)
    return {"device_ms": dev_ms, "bf16_device_ms": bf16_ms}


def _vit_head_dim(a, name, hd):
    """The per-item attention kernels' or the fused layer's arguments with
    the same codes read at head_dim ``hd``: more heads of the same width, or
    (split q/k/v) each head's leading ``hd`` columns."""
    a = list(a)
    if name == "lis_attention":
        a[:3] = [t[..., :hd].contiguous() for t in a[:3]]
    elif name == "lis_attention_fused":
        a[1] = a[0].shape[2] // 3 // hd
    else:
        a[5] = a[0].shape[2] // hd
    return a


def _vit_plan_checks(ops, name, a, k, want):
    """Element mismatches of the fused layer and the per-item attention
    kernels against their plain versions on one call's arguments: on forced
    plans (the layer on 7 CTAs, on 1 and 4 query groups a chunk and on
    phase-C blocks of 32 and 64 rows, the attention on 1 and 4 groups a
    chunk) and with the codes read at head_dims 32 and 16 (the layer at
    32) and, on the batch-8 calls (the plain versions' score tensors grow
    with the heads), at 8, 4, 2 and 1."""
    out = {}
    al, lf = ops.attention_lis, ops.layer_fused
    want = _as_tuple(want)
    if name == "fused_vit_layer":
        for grid, gc, br in ((7, 0, 0), (0, 1, 0), (0, 4, 0), (0, 0, 32), (0, 0, 64)):
            out[f"layer grid {grid} gc {gc} br {br}"] = sum(_diff(g, w)[0] for g, w in zip(
                lf.fused_vit_layer_forced(*a, **k, grid=grid, gc=gc, br=br), want))
    else:
        forced = al.lis_attention_fused_forced if name == "lis_attention_fused" else al.lis_attention_forced
        for gc in (1, 4):
            out[f"{name} gc {gc}"] = _diff(forced(*a, **k, gc=gc), want[0])[0]
    plain = getattr(getattr(ops, SOURCES[name][0]), SOURCES[name][1])
    small = (8, 4, 2, 1) if a[0].numel() <= 2_000_000 else ()  # DeiT-S at batch 8, not 64
    for hd in ((32,) if name == "fused_vit_layer" else (32, 16)) + small:
        b = _vit_head_dim(a, name, hd)
        out[f"{name} head_dim {hd}"] = sum(_diff(g, w)[0] for g, w in zip(
            _as_tuple(getattr(ops, name)(*b, **k)), _as_tuple(plain(*b, **k))))
    return out


def _layer_launch_report(ops, a, k):
    """The fused layer's launch facts at one shape (CUDA runtime)."""
    (b, n, c), hid = a[0].shape, a[19].shape[0]
    info = ops.layer_fused.layer_kernel_info(b, n, c, a[5], hid, k.get("lis", True))
    return (f"{info['threads']} threads a CTA (three warpgroups, each its own TMA ring), a cooperative grid of "
            f"{info['grid']} CTAs ({info['ctas_per_sm']} per SM of {info['sms']}), {info['smem_bytes']} B shared "
            f"memory (phases {info['smem_a']} / {info['smem_b']} / {info['smem_c']}), {info['ring']} ring stages "
            f"of {info['chunk']}-column chunks, {info['blocks']} row blocks ({info['blocks_64']} of 64 rows, the "
            f"rest of 32), {info['gc']} query groups a chunk at head_dim {info['hdp']}, "
            f"{info['registers']} registers ({info['spill_bytes']} B spilled)")


def _vit_attention_launch_report(ops, name, a, k):
    """A per-item attention kernel's launch facts at one shape."""
    n = a[0].shape[1]
    hd = a[0].shape[2] if name == "lis_attention" else a[0].shape[2] // 3 // a[1]
    info = ops.attention_lis.vit_attention_info(n, hd, k.get("lis", True))
    return (f"one (image, head) item a CTA, head_dim {hd} padded to {info['hdp']}, {info['gc']} query groups a "
            f"chunk, {info['smem_bytes']} B shared memory, {info['ctas_per_sm']} CTAs per SM, {info['registers']} "
            f"registers ({info['spill_bytes']} B spilled)")


def _layer_phases(kern, a, k, reps=5):
    """The fused layer's three phases (qkv GEMM, attention, row blocks), ms
    per call by block 0's %globaltimer, mean of ``reps`` calls."""
    stamps = torch.zeros((reps, 4), dtype=torch.int64, device=a[0].device)
    for r in range(reps):
        kern(*a, **k, phase_ns=stamps[r])
    torch.cuda.synchronize()
    ms = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0).tolist()
    return (f"qkv GEMM {ms[0] / 1e6:.4f} ms, attention {ms[1] / 1e6:.4f} ms, "
            f"row blocks {ms[2] / 1e6:.4f} ms per call (block 0's clock, mean of {reps})")


def _qkv_cluster_report(ops, a, k, count, reps):
    """The cluster kernel's launch facts (CUDA runtime) and its ms per
    forward beside the staged pair on the same arguments: the qkv
    ``int8_matmul_requant`` then ``lis_attention_fused`` (CUDA events, and
    device ms from the profiler)."""
    al, mi = ops.attention_lis, ops.matmul_int8
    h, w, rv, bv, heads = a[:5]
    b, n, c_in = h.shape
    info = al.qkv_kernel_info(n, k.get("lis", True))

    def staged():
        qkv = mi.int8_matmul_requant(h.reshape(-1, c_in), w, rv, bv)
        return al.lis_attention_fused(qkv.reshape(b, n, -1), heads, *a[5:], **k)

    parts = []
    for label, fn in (("cluster kernel", lambda: al.lis_attention_qkv_fused(*a, **k)), ("staged pair", staged)):
        t = _time_ms(fn, reps)
        dev_ms, _, _ = _device_ms(fn, 5)
        dev = "device not measured" if dev_ms is None else f"device {dev_ms * count:.4f}"
        parts.append(f"{label} {t * count:.4f} ms ({dev}) per forward")
    stamps = torch.zeros((5, 6), dtype=torch.int64, device=h.device)
    for row in stamps:
        al.lis_attention_qkv_fused(*a, **k, phase_ns=row)
    torch.cuda.synchronize()
    us = ((stamps[:, 1:] - stamps[:, :-1]).double().mean(0) / 1e3).tolist()
    phases = ", ".join(f"{name} {t:.2f}" for name, t in zip(al.QKV_PHASES, us))
    return (f"cluster {info['cluster']} CTAs, {info['smem_bytes']} B shared memory per CTA, "
            f"{info['registers']} registers ({info['spill_bytes']} B spilled), {info['ctas_per_sm']} CTAs per SM, "
            f"max active clusters {info['max_active_clusters']}; {'; '.join(parts)} (x{count}); "
            f"the middle cluster's rank-0 CTA's phases (us, mean of 5 calls): {phases}")


def _requant_launch_report(ops, a, k, t_k, reps):
    """The int8 kernel's plan and launch facts at one shape (CUDA runtime),
    its time on one tile per CTA (the grid hook: no persistent ring), and
    ``torch._int_mm``'s time for the int32 product alone (not the same
    function: a reference, not ``library_ms``)."""
    mi = ops.matmul_int8
    x, w = a[0], a[1]
    (m, kk), n = x.shape, w.shape[0]
    gelu = bool(k.get("gelu", a[7] if len(a) > 7 else False))
    info = mi.requant_kernel_info(m, n, kk, gelu)
    tiles = info["tiles_m"] * info["tiles_n"]
    one = _time_ms(lambda: mi.int8_matmul_requant_grid(*a, **k, grid=tiles), reps)
    wt = w.t()
    int_mm = f"{_time_ms(lambda: torch._int_mm(x, wt), reps):.4f} ms" if m > 16 else "not measured (M <= 16)"
    return (f"BN {info['bn']}, {info['nc']} consumer warpgroups, {info['stages']} stages, {tiles} tiles on a "
            f"persistent grid of {info['grid']} CTAs ({info['ctas_per_sm']} per SM of {info['sms']}), "
            f"{info['smem_bytes']} B shared memory, {info['registers']} registers at launch, "
            f"{info['consumer_registers']} per consumer thread, {info['spill_bytes']} B spilled; "
            f"{t_k:.4f} ms per call, one tile per CTA {one:.4f} ms, torch._int_mm {int_mm}")


def _res_ln_launch_report(ops, a, t_k, reps):
    """The junction kernel's plan and launch facts at one shape (CUDA
    runtime), and ``torch._int_mm``'s time for its int32 product alone (not
    the same function: a reference, not ``library_ms``)."""
    x, w = a[0], a[1]
    (m, kk), n = x.shape, w.shape[0]
    info = ops.matmul_ln.res_ln_kernel_info(m, n)
    wt = w.t()
    int_mm = f"{_time_ms(lambda: torch._int_mm(x, wt), reps):.4f} ms" if m > 16 else "not measured (M <= 16)"
    return (f"clusters of {info['cs']} CTAs splitting N, each {info['cpc']} chunk(s) of BN {info['bn']}, "
            f"{info['nc']} consumer warpgroups of 64 rows, {info['stages']} stages, {info['blocks']} row blocks "
            f"on a persistent grid of {info['grid']} CTAs ({info['ctas_per_sm']} per SM of {info['sms']}, "
            f"{info['resident'][info['cs'] - 1]} clusters resident at most), {info['smem_bytes']} B shared memory, "
            f"{info['registers']} registers at launch, {info['consumer_registers']} per consumer thread, "
            f"{info['spill_bytes']} B spilled; {t_k:.4f} ms per call, torch._int_mm {int_mm}")


def _intln_launch_report(ops, name, a, t_k):
    """An int-LN kernel's plan and launch facts at one shape (CUDA runtime)."""
    res = name == "int_res_ln_requant"
    m, c = a[0].shape
    info = ops.intln.ln_kernel_info(m, c, res)
    return (f"G {info['g']} lanes a row, {info['k']} 16-byte chunk(s) a lane, {info['rows']} rows a CTA block, "
            f"{info['blocks']} blocks on a {'persistent ' if info['blocks'] > info['grid'] else ''}grid of "
            f"{info['grid']} CTAs ({info['ctas_per_sm']} per SM of {info['sms']}), "
            f"{info['smem_bytes']} B shared memory, {info['registers']} registers ({info['spill_bytes']} B spilled); "
            f"{t_k:.4f} ms per call")


def _prologue_checks(ops, name, a, k, want):
    """Element mismatches of a prologue kernel against its plain version on
    one call's arguments, on forced plans: the embed on every cluster size
    and consumer count that fits, and on the same patches as float32 values
    quantized in the kernel (s_input 1: the codes themselves); its PTF
    divide against __fdiv_rn over all 2^32 dividends for each distinct
    s_qact1 value; the stem on one block a CTA and on 7 CTAs."""
    out = {}
    if name == "fused_patch_embed":
        ef = ops.embed_fused
        (b, n_patch, kk), c = a[0].shape, a[1].shape[0]
        info = ef.embed_kernel_info(b * n_patch, c)
        for cs in range(1, ef.MAX_CLUSTER + 1):
            for nc in range(1, ef.MAX_CONSUMERS + 1):
                try:
                    ef.embed_plan(b * n_patch, c, kk, info["sms"], info["resident"], cs=cs, nc=nc)
                except ValueError:
                    continue
                out[f"embed cs{cs} nc{nc}"] = sum(_diff(g, w)[0] for g, w in zip(ef.fused_patch_embed_forced(
                    *a, **k, cs=cs, nc=nc), want))
        fa = (a[0].to(torch.float32),) + tuple(a[1:])
        one = torch.ones((), device=a[0].device)
        out["embed float32 arm"] = sum(_diff(g, w)[0] for g, w in zip(ef.fused_patch_embed(
            *fa, **{**k, "s_input": one}), want))
        sq1 = torch.as_tensor(k["s_qact1"] if "s_qact1" in k else a[8], dtype=torch.float32,
                              device=a[0].device).reshape(-1).unique()
        out["embed divide"] = sum(ef.embed_div_check(sq1))
    else:
        st = ops.swin_stem
        plan = st.stem_plan(a[0].shape[0], a[0].shape[1], a[1].shape[0])
        for g in (plan.blocks, 7):
            out[f"stem grid {'blocks' if g == plan.blocks else g}"] = _diff(st.fused_swin_stem_forced(*a, **k, grid=g),
                                                                          want[0])[0]
    return out


def _prologue_launch_report(ops, name, a, k, t_k, b_ms):
    """A prologue kernel's plan and launch facts at one shape (CUDA runtime)
    and its device µs per call, all the wrapper launches and the kernel
    alone (profiler), against its bound; the stem also against its
    multiply-and-add ceiling."""
    fn = getattr(ops, name)
    _, _, by_name = _device_ms(lambda: fn(*a, **k), 5)
    call_us = sum(by_name.values()) * 1e3
    kern_us = sum(v for n, v in by_name.items() if re.search(r"embed_kernel<|swin_stem_kernel<", n)) * 1e3
    if name == "fused_patch_embed":
        (b, n_patch, _), c = a[0].shape, a[1].shape[0]
        info = ops.embed_fused.embed_kernel_info(b * n_patch, c)
        plan = (f"clusters of {info['cs']} CTAs splitting C, each {info['cpc']} chunk(s) of BN {info['bn']}, "
                f"{info['nc']} consumer warpgroups of 64 patch rows, {info['stages']} stages, {info['blocks']} row "
                f"blocks on a persistent grid of {info['grid']} CTAs ({info['resident'][info['cs'] - 1]} clusters "
                f"resident at most), {info['smem_bytes']} B shared memory, {info['registers']} registers at launch, "
                f"{info['consumer_registers']} per consumer thread, {info['spill_bytes']} B spilled")
        ceiling = ""
    else:
        (m, kk), c = a[0].shape, a[1].shape[0]
        info = ops.swin_stem.stem_kernel_info(m, kk, c)
        plan = (f"4 rows × {info['cc']} channels a thread, {info['blocks']} blocks of {info['rows']} patch rows on "
                f"a persistent grid of {info['grid']} CTAs ({info['ctas_per_sm']} per SM of {info['sms']}), "
                f"{info['smem_bytes']} B shared memory, {info['registers']} registers ({info['spill_bytes']} B "
                f"spilled), {ops.swin_stem.stem_plan(m, kk, c).loads_per_product:.3f} shared loads a product")
        ops, peak = _ops(name, a)
        ceil_us = 2 * ops / peak * 1e6
        ceiling = f", {kern_us / ceil_us:.2f}x the multiply-and-add ceiling {ceil_us:.2f} us"
    return (f"{plan}; {t_k:.4f} ms per call (CUDA events), device {call_us:.2f} us per call, the kernel alone "
            f"{kern_us:.2f} us, {kern_us / (1e3 * b_ms):.2f}x its bound {1e3 * b_ms:.2f} us{ceiling}")


def _swin_geometry(name, a):
    """(windows, windows per image, heads, N, fold) of a Swin attention call."""
    qkv, heads = a[0], a[3]
    if name == "swin_lis_attention_folded":
        b, res = qkv.shape[:2]
        g2 = (res // a[4]) ** 2
        return b * g2, g2, heads, a[4] * a[4], True
    w, n = qkv.shape[:2]
    return w, a[4] if a[2] is not None else 1, heads, n, False


def _swin_entry_checks(ops, a, k):
    """Element mismatches of the Swin kernel against its plain version on one
    panel call's arguments: forced grids of one item per CTA and of 7 CTAs
    (runs across heads and window positions), and the folded entry on the
    raster grid the panels tile (window_reverse) at shift 0 and ws // 2
    (stages of more than one window)."""
    from p2vit_tpu_torch.models.swin import window_reverse

    al = ops.attention_lis
    qkv, heads, nw = a[0], a[3], a[4]
    w, n, _ = qkv.shape
    want = al.swin_lis_attention_plain(*a, **k)
    out = {}
    for g in (w * heads, 7):
        out[f"panel grid {'items' if g == w * heads else g}"] = _diff(al.swin_lis_attention(*a, **k, grid=g), want)[0]
    ws, g2 = round(n ** 0.5), round(nw ** 0.5)
    if g2 > 1 and ws * ws == n and g2 * g2 == nw:
        res = g2 * ws
        raster = window_reverse(qkv, ws, res, res).contiguous()
        for shift in (0, ws // 2):
            fa = (raster, a[1], a[2], heads, ws) + tuple(a[5:])
            out[f"folded shift {shift}"] = _diff(al.swin_lis_attention_folded(*fa, **k, shift=shift),
                                                 al.swin_lis_attention_folded_plain(*fa, **k, shift=shift))[0]
    return out


def _swin_launch_report(ops, name, a, k, t_k, reps):
    """The Swin kernel's plan and launch facts at one shape (CUDA runtime),
    its time with one item per CTA (the forced-grid hook) and the middle
    CTA's phases summed over its items (the %globaltimer hook)."""
    al = ops.attention_lis
    windows, nw, heads, n, fold = _swin_geometry(name, a)
    lis = bool(k.get("lis", True))
    info = al.swin_attention_info(n, lis, fold)
    plan = al.swin_attention_plan(windows, nw, heads, n, info["sms"], info["ctas_per_sm"], lis=lis)
    kern = getattr(al, name)
    one = _time_ms(lambda: kern(*a, **k, grid=plan.items), reps)
    stamps = torch.zeros((5, 16), dtype=torch.int64, device=a[0].device)  # 16-byte aligned rows
    for row in stamps:
        kern(*a, **k, phase_ns=row[:9])
    spans = torch.zeros(2 * plan.grid, dtype=torch.int64, device=a[0].device)
    kern(*a, **k, cta_ns=spans)
    torch.cuda.synchronize()
    us = (stamps[:, :6].double().mean(0) / 1e3).tolist()
    names = al.SWIN_PHASES if lis else al.SWIN_PHASES_LISOFF
    phases = ", ".join(f"{nm} {t:.2f}" for nm, t in zip(names, us))
    se = spans.view(-1, 2).double() / 1e3
    dur = (se[:, 1] - se[:, 0]).sort().values
    return (f"{plan.items} items on a grid of {plan.grid} CTAs ({info['ctas_per_sm']} per SM of {info['sms']}) "
            f"taking them in turn, {plan.items / plan.grid:.2f} items a CTA, mask "
            f"{'with every item' if a[2] is not None else 'none'}, {info['smem_bytes']} B shared memory, "
            f"{info['registers']} registers ({info['spill_bytes']} B spilled), MMA tiles a warp per item (scores, "
            f"attn@v) {plan.warp_tiles}; {t_k:.4f} ms per call, one item per CTA {one:.4f} ms; the middle CTA's "
            f"{int(stamps[0, 6])} items, {int(stamps[0, 8])} bias stagings (us per call, mean of 5): {phases}, "
            f"total {us[5]:.2f}; CTA durations us min {float(dur[0]):.2f} median {float(dur[len(dur) // 2]):.2f} "
            f"max {float(dur[-1]):.2f}, span {float(se[:, 1].max() - se[:, 0].min()):.2f}")


def _img_s(bt, ms):
    return f"{bt / ms * 1e3:.1f} img/s ({ms:.4f} ms)"


def print_comparisons(summary, bt):
    """Staged against fused and LIS off against LIS on, both on float32
    input, then uint8 against float32: img/s at batch ``bt`` through the
    kernels, one pair per line."""
    pairs = (("staged vs fused", "DeiT-S staged", "DeiT-S"),
             ("staged vs fused, LIS off", "DeiT-S staged LIS-off", "DeiT-S LIS-off"),
             ("LIS off vs LIS on", "DeiT-S LIS-off", "DeiT-S"),
             ("LIS off vs LIS on, staged", "DeiT-S staged LIS-off", "DeiT-S staged"),
             ("LIS off vs LIS on", "Swin-T LIS-off", "Swin-T"))
    for label, a, b in pairs:
        if a in summary and b in summary:
            print(f"phase 5 compare {label}, batch {bt}, float32 input: {a} "
                  f"{_img_s(bt, summary[a]['f32_ms'])} vs {b} {_img_s(bt, summary[b]['f32_ms'])}")
    for name, t in summary.items():
        if t["f32_ms"] != t["ms"]:
            print(f"phase 5 compare uint8 vs float32 input, batch {bt}: {name} uint8 "
                  f"{_img_s(bt, t['ms'])} vs float32 {_img_s(bt, t['f32_ms'])}")


def print_flag_comparisons(paths, summary, bt):
    """Each Swin-T flag path against the default path on the same state and
    requests: img/s at batch ``bt`` (CUDA events), and device ms per forward
    with the other PyTorch kernels' share (profiler)."""
    def dev(t):
        if t["device_ms"] is None:
            return "device ms not measured"
        return f"device {t['device_ms']:.4f} ms (other PyTorch {t['other_ms']:.4f})"

    for p in paths:
        if p.base_name in summary and not p.key.startswith("deit"):
            a, b = summary[p.name], summary[p.base_name]
            print(f"phase 5 compare {p.name} vs {p.base_name}, batch {bt}: {_img_s(bt, a['ms'])}, "
                  f"{dev(a)} vs {_img_s(bt, b['ms'])}, {dev(b)}")


def print_layer_comparisons(paths, summary, batches, img, reps):
    """``deit_layer`` against ``deit`` on the same requests, at every batch:
    img/s (CUDA events around whole forwards, host gaps included), device ms
    per forward (profiler), the other PyTorch kernels' ms and the idle share
    (1 − device ms / event ms). The largest batch reuses phase 5's readings
    of both paths."""
    bt = max(batches)
    for p in paths:
        if p.key != "deit_layer":
            continue
        for b in batches:
            x = img(b, p.img_size, p.u8_state is not None)
            parts = []
            for name, key, fwd in ((p.name, p.key, p.forward), (p.base_name, p.base_key, p.base)):
                if b == bt and name in summary:
                    t = summary[name]
                    ms, dev_ms, other = t["ms"], t["device_ms"], t["other_ms"]
                else:
                    with torch.no_grad():
                        ms = _time_ms(lambda: fwd(x, True), max(2, reps // 4))
                        dev_ms, port_ms, _ = _device_ms(lambda: fwd(x, True), 5)
                    other = None if dev_ms is None else dev_ms - port_ms
                dev = ("device ms not measured" if dev_ms is None else
                       f"device {dev_ms:.4f} ms, other PyTorch {other:.4f} ms, "
                       f"idle share {1 - dev_ms / ms:.3f}")
                parts.append(f"{key} {_img_s(b, ms)}, {dev}")
            print(f"phase 5 compare {p.key} vs {p.base_key}, batch {b}: {parts[0]} vs {parts[1]}",
                  flush=True)


# ---------------------------------------------------------------------------
# Weight-only serving and the two weight-store tools
# ---------------------------------------------------------------------------


def _diff(got, want):
    """(elements that differ bit for bit, max |got − want|) of a kernel's
    output against its plain version's."""
    if got.dtype == torch.bfloat16:
        n = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        return n, float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return int((d != 0).sum()), int(d.max()) if got.numel() else 0


def _bf16_ulp(a, b):
    """Per-element bf16 ulp distance (0 == bitwise)."""
    def key(x):
        u = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - (u & 0x7FFF) - 1, u + 0x8000)

    return (key(a) - key(b)).abs()


def _wonly_pairs_vit(pw, s):
    """(name, effective weight, serving layer, SmoothQuant-folded) of every
    weight of a ViT weight-only tree."""
    yield "patch_embed", pw["patch_embed"]["w"], s["patch"], False
    yield "head", pw["head"]["w"], s["head"], False
    for i, (nb, sb) in enumerate(zip(pw["blocks"], s["blocks"])):
        for key, lk, smooth in (("qkv", "qkv", True), ("proj", "proj", False), ("fc1", "mlp_fc1", True),
                                ("fc2", "fc2", False)):
            yield f"blocks.{i}.{key}", nb[key]["w"], sb[lk], smooth


def _wonly_pairs_swin(pw, s):
    yield "patch_embed", pw["patch_embed"]["w"], s["patch"], False
    yield "head", pw["head"]["w"], s["head"], False
    for i, (stage, st) in enumerate(zip(pw["stages"], s["stages"])):
        for j, (blk, sb) in enumerate(zip(stage["blocks"], st["blocks"])):
            for key in ("qkv", "proj", "fc1", "fc2"):
                yield f"stages.{i}.blocks.{j}.{key}", blk[key]["w"], sb[key], False
        if "downsample" in stage:
            yield f"stages.{i}.reduction", stage["downsample"]["reduction"]["w"], st["downsample"]["red"], False


def _roundtrip(pairs):
    """(codes that differ, codes) after requantizing each effective weight
    with the serving scales (× cs on the folded layers)."""
    bad = total = 0
    for _, w_eff, layer, smooth in pairs:
        w = w_eff * layer["cs"][None, :] if smooth else w_eff
        bad += int((torch.round(w / layer["sw"][:, None]) != layer["w_q"].to(w.dtype)).sum())
        total += w.numel()
    return bad, total


def wstream_on_forward(name, vit, s, fwd, xs, blocks, mw):
    """Phase 1 of ``deit_wonly``: ``wstream_matmul`` in every store against
    its plain version on the four GEMMs of ``blocks``, with the activations
    the weight-only forward gives them (1/cs folded into x on qkv and fc1),
    the codes, sw and the bias of the serving state; and the ulp distance
    of the gelu=False output to the forward's own bf16 linear (report)."""
    from p2vit_tpu_torch.tools.wstream_bench import PACK, wide_span_x

    mism = {f: 0 for f in mw.FORMATS}
    wide = {f: 0 for f in mw.FORMATS}
    ulp_max, ulp_sum, n_out = 0, 0, 0
    pot_cs = True
    rng = np.random.RandomState(WIDE_SPAN)
    for x in xs:
        calls = _capture([vit], ["linear"], lambda: fwd(x))["linear"]
        for bi in blocks:
            sb = s["blocks"][bi]
            for j, (lk, smooth, gelu) in enumerate((("qkv", True, False), ("proj", False, False),
                                                    ("mlp_fc1", True, True), ("fc2", False, False))):
                a, _ = calls[1 + 4 * bi + j]
                y_lin = vit.linear(*a)
                layer = sb[lk]
                x2 = a[0].reshape(-1, a[0].shape[-1])
                if smooth:
                    pot_cs = pot_cs and _is_pot(layer["cs"])
                    x2 = (x2.to(torch.float32) / layer["cs"][None, :]).to(torch.bfloat16)
                xw = wide_span_x(*x2.shape, WIDE_SPAN, rng, x2.device)
                for fmt in mw.FORMATS:
                    store = PACK[fmt](layer["w_q"])
                    for g in sorted({False, gelu}):
                        got = mw.wstream_matmul(x2, store, layer["sw"], layer["bias"], fmt, g)
                        mism[fmt] += _diff(got, mw.wstream_matmul_plain(x2, store, layer["sw"], layer["bias"],
                                                                        fmt, g))[0]
                        wide[fmt] += _diff(mw.wstream_matmul(xw, store, layer["sw"], layer["bias"], fmt, g),
                                           mw.wstream_matmul_plain(xw, store, layer["sw"], layer["bias"], fmt,
                                                                   g))[0]
                        if not g:
                            u = _bf16_ulp(got, y_lin.reshape(got.shape))
                            ulp_max, ulp_sum, n_out = max(ulp_max, int(u.max())), ulp_sum + int(u.sum()), n_out + u.numel()
    torch.cuda.synchronize()
    print(f"{name} phase 1 wstream_matmul vs plain on blocks {list(blocks)}' GEMMs (batch "
          f"{', '.join(str(x.shape[0]) for x in xs)}, 1/cs folded into x, cs a power of two: {pot_cs}): "
          f"mismatches {json.dumps(mism)}; on a {WIDE_SPAN}-binade x of the same shapes {json.dumps(wide)}; "
          f"ulp distance to the forward's bf16 linear: max {ulp_max}, "
          f"mean {ulp_sum / max(n_out, 1):.6g} (report only)", flush=True)
    if any(mism.values()) or any(wide.values()):
        _fail(f"{name}: wstream_matmul disagrees with its plain version: {mism}, wide-span {wide}")


def run_wonly(name, model, cfg, params, pw, pairs, int8_fwd, simulate, batches, reps, img, counts_api,
              wstream=None):
    """``deit_wonly`` / ``swin_wonly``: the round trip to convert's codes,
    the bf16 weight-only forward (launching no kernel of the port), its
    agreement with the int8 path and the simulation, and its time beside
    the bf16 forward of the unquantized params. ``wstream``: (s, blocks, mw)
    for the phase-1 hold of ``wstream_matmul`` on its GEMMs."""
    reset_launch_counts, launch_counts = counts_api
    bad, total = _roundtrip(pairs)
    print(f"{name} phase 2 round trip: requantized effective weights != convert's codes: {bad} of "
          f"{total}", flush=True)
    if bad:
        _fail(f"{name}: weight_only_params does not round-trip to convert's codes ({bad} of {total})")
    pw16, pbf = _cast_tree(pw, torch.bfloat16), _cast_tree(params, torch.bfloat16)

    def fwd(x):
        return model.fp_forward(pw16, cfg, x.to(torch.bfloat16))

    def base(x):
        return model.fp_forward(pbf, cfg, x.to(torch.bfloat16))

    requests = {b: img(b, cfg.img_size) for b in batches}
    if wstream is not None:
        s, blocks, mw = wstream
        with torch.no_grad():
            wstream_on_forward(name, model, s, fwd, [requests.get(8, img(8, cfg.img_size)),
                                                     requests[max(batches)]], blocks, mw)
    reset_launch_counts()
    with torch.no_grad():
        logits = {b: fwd(x) for b, x in requests.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"{name} phase 3 launches over {len(batches)} forwards: {json.dumps(counts)} (the weight-only "
          f"forward runs PyTorch's bf16 GEMMs: 0 expected)", flush=True)
    if any(counts.values()):
        _fail(f"{name}: the weight-only forward launched a kernel of the port: {counts}")
    for b, lg in logits.items():
        lg = lg.float()
        if tuple(lg.shape) != (b, cfg.num_classes) or not bool(torch.isfinite(lg).all()):
            _fail(f"{name} batch {b}: logits shape {tuple(lg.shape)} or non-finite values")
        with torch.no_grad():
            i8, sim, fp = int8_fwd(requests[b]), simulate(requests[b]), base(requests[b]).float()
        agree = {k: float((lg.argmax(1) == v.argmax(1)).float().mean()) for k, v in
                 (("int8 path", i8), ("quant_forward", sim), ("unquantized bf16", fp))}
        rel = float((lg - sim).norm() / sim.norm().clamp_min(1e-9))
        print(f"{name} phase 4 batch {b}: logits finite {tuple(lg.shape)}; argmax agreement "
              f"{json.dumps(agree)}; vs quant_forward rel {rel:.6g} (report only)")
    for b, x in requests.items():
        parts = []
        for label, fn in (("weight-only bf16", fwd), ("unquantized bf16", base)):
            with torch.no_grad():
                ms = _time_ms(lambda: fn(x), max(2, reps // 4))
                dev_ms, _, _ = _device_ms(lambda: fn(x), 5)
            dev = "device ms not measured" if dev_ms is None else f"device {dev_ms:.4f} ms"
            parts.append(f"{label} {_img_s(b, ms)}, {dev}")
        print(f"{name} phase 5 batch {b}: {parts[0]} vs {parts[1]}", flush=True)


def _timed_rows(name, rows, reps):
    """ms, plain ms, bound ms and library ms per chain from (kernel, plain,
    args, kwargs, count, label, library call or None) rows, each timed with
    CUDA events; library ms is None where no row has a library call."""
    k_ms = p_ms = l_ms = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for kern, plain, a, k, count, label, library in rows:
        t_k = _time_ms(lambda: kern(*a, **k), reps)
        t_p = _time_ms(lambda: plain(*a, **k), reps)
        b_ms, b_by = _bound(name, a, [plain(*a, **k)])
        line = f"{label}: {t_k:.4f} ms vs plain {t_p:.4f} ms per call, bound {b_ms:.6f} ms ({b_by})"
        if library is not None:
            t_l = _time_ms(library, reps)
            l_ms += t_l * count
            line += f", library bf16 GEMM {t_l:.4f} ms"
        print(f"{line}, x{count} per chain")
        k_ms, p_ms = k_ms + t_k * count, p_ms + t_p * count
        by[b_by] += b_ms * count
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": by["bytes"] + by["operations"],
            "bound_by": max(by, key=by.get), "library_ms": l_ms if any(r[-1] for r in rows) else None}


def run_w4pack(batches, reps, depth, dev, deit, ops, counts_api):
    """The ported w4pack_latency tool at the DeiT-S GEMMs, M = 197·batch."""
    from p2vit_tpu_torch import serving
    from p2vit_tpu_torch.tools import _gemm_bench as gb
    from p2vit_tpu_torch.tools import w4pack_latency as wl

    reset_launch_counts, launch_counts = counts_api
    mi, name = ops.matmul_int8, "w4pack"
    ms = [197 * b for b in batches]
    mism = {"vs plain": 0, "vs int8 kernel": 0, "forced grids": 0}
    worst = 0

    def hold(a, k):
        nonlocal worst
        x, w = a[0], a[1]
        got = mi.int4_matmul_requant(x, mi.pack_int4(w), *a[2:], **k)
        n, e = _diff(got, mi.int4_matmul_requant_plain(x, mi.pack_int4(w), *a[2:], **k))
        mism["vs plain"] += n
        worst = max(worst, e)
        mism["vs int8 kernel"] += _diff(got, mi.int8_matmul_requant(x, w, *a[2:], **k))[0]

    rows, launch_lines = [], []
    for m in ms:
        rng = np.random.RandomState(m)
        for gname, k, n, gelu in (*gb.DEIT_S_GEMMS, gb.CONTROL):
            x, stores, r, b, kw = wl.gemm_case(m, k, n, gelu, rng, dev)
            hold((x, stores["i8"], r, b), kw)
            if m == ms[-1]:
                a4 = (x, stores["w4p"], r, b)
                want = mi.int4_matmul_requant_plain(*a4, **kw)
                for grid in (1, 3, mi.int4_requant_plan(m, n, k, 1, gelu).tiles):
                    mism["forced grids"] += _diff(mi.int4_matmul_requant_grid(*a4, **kw, grid=grid), want)[0]
                launch_lines.append(_int4_launch_report(mi, gname, m, n, k, gelu))
                if gname != gb.CONTROL[0]:
                    rows.append((mi.int4_matmul_requant, mi.int4_matmul_requant_plain, a4, kw, depth,
                                 f"{name} phase 5 kernel int4_matmul_requant {gname} M={m}", None))
    s, cfg = deit["s"], deit["cfg"]
    seen = {}
    for bsz in sorted({8, max(batches)}):
        calls = _capture([mi], ["int8_matmul_requant_plain"], lambda: serving.serving_forward(
            s, cfg, deit["img"](bsz), use_kernels=False))
        for a, k in calls["int8_matmul_requant_plain"]:
            seen.setdefault(_shape_key(a, k), (a, k))
    for a, k in seen.values():
        hold(a, k)
    torch.cuda.synchronize()
    print(f"{name} phase 1 int4_matmul_requant (the tool's constants at M={ms}, on forced grids of 1 and 3 "
          f"CTAs and one tile a CTA at M={ms[-1]}, and the deit path's {len(seen)} fc1/head argument shapes, "
          f"codes packed with pack_int4): mismatches {json.dumps(mism)}", flush=True)
    if any(mism.values()):
        _fail(f"{name}: int4_matmul_requant disagrees: {mism}")

    cases = [wl.chain_case(m, m + 1, depth, dev) for m in ms]
    reset_launch_counts()
    outs = [(wl.chain("i8", *c), wl.chain("w4p", *c)) for c in cases]
    torch.cuda.synchronize()
    counts = launch_counts()
    same = all(torch.equal(a, b) for a, b in outs)
    print(f"{name} phase 2 depth-{depth} chain at M={ms}: i8 store == packed store: {same}", flush=True)
    per_chain = 4 * depth
    want = {kk: 0 for kk in counts}
    want.update(int8_matmul_requant=per_chain * len(ms), int4_matmul_requant=per_chain * len(ms))
    print(f"{name} phase 3 launches over {len(ms)} chain calls per arm: {json.dumps(counts)} "
          f"({per_chain} per chain call)", flush=True)
    if not same or counts != want:
        _fail(f"{name}: chain pin {same} or launch counts {counts} != {want}")

    for line in launch_lines:
        print(f"{name} phase 5 {line}", flush=True)
    for m in ms:
        print(f"{name} phase 5 DeiT-S GEMMs at M={m} (tool lines)")
        rng = np.random.RandomState(m)
        for gname, k, n, gelu in (*gb.DEIT_S_GEMMS, gb.CONTROL):
            wl.run_gemm(gname, m, k, n, gelu, rng, reps, dev)
        wl.run_depth_chain(m, m + 1, max(2, reps // 4), depth, dev)
    res = _timed_rows("int4_matmul_requant", rows, reps)
    chains = {}
    for m, case in zip(ms, cases):
        chains[m] = _chain_device_ms(name, ("i8", "w4p"), lambda arm, case=case: wl.chain(arm, *case), depth, m)
        port = {arm: chains[m][arm][1] for arm in ("i8", "w4p")}
        bound = {arm: _w4pack_chain_bound(gb, m, depth, arm == "w4p") for arm in ("i8", "w4p")}
        ratio = f"{port['w4p'] / port['i8']:.3f}" if None not in port.values() else "not measured"
        print(f"{name} phase 5 depth-{depth} chains at M={m}, the port's kernels' device ms: "
              + "; ".join(f"{arm} {'not measured' if port[arm] is None else f'{port[arm]:.4f}'} (bound "
                          f"{bound[arm][0]:.6f} ms, {bound[arm][1]})" for arm in ("i8", "w4p"))
              + f"; w4p / i8 {ratio}", flush=True)
    res.update(launches=counts["int4_matmul_requant"], max_abs_err=worst, device_ms=chains[ms[-1]]["w4p"][0])
    return {"int4_matmul_requant": res}


def _int4_launch_report(mi, gname, m, n, k, gelu):
    """The int4-store kernel's packed plan and launch facts at one GEMM
    (CUDA runtime)."""
    info = mi.int4_kernel_info(m, n, k, gelu)
    return (f"int4_matmul_requant launch {gname} M={m} K={k} N={n}: BN {info['bn']}, {info['nc']} consumer "
            f"warpgroups, {info['stages']} stages of {mi.stage_bytes(info['bn'])} B (a packed box and two x boxes "
            f"of 64-byte rows, the high B tile), {info['tiles_m'] * info['tiles_n']} tiles on a persistent grid of "
            f"{info['grid']} CTAs ({info['ctas_per_sm']} per SM of {info['sms']}), {info['smem_bytes']} B shared "
            f"memory, {info['registers']} registers at launch, {info['consumer_registers']} per consumer thread, "
            f"{info['spill_bytes']} B spilled")


def _w4pack_chain_bound(gb, m, depth, packed):
    """(ms, what sets it) of a depth-``depth`` chain of the tools' DeiT-S
    GEMMs at M rows: per GEMM the larger of its bytes (x, the store: N·K or,
    packed, N·K/2; r, b and the int8 output) over the HBM rate and its int8
    products over their peak, summed."""
    total, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for _, k, n, _ in gb.DEIT_S_GEMMS:
        nbytes = m * k + n * k // (2 if packed else 1) + 8 * n + m * n
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, 2 * m * n * k / INT8_OPS_S * 1e3
        by["bytes" if t_bytes >= t_ops else "operations"] += max(t_bytes, t_ops) * depth
        total += max(t_bytes, t_ops) * depth
    return total, max(by, key=by.get)


def _chain_device_ms(name, arms, run, depth, m):
    """Device ms per chain call of each arm (profiler, 3 calls), printed with
    its largest kernels; returns {arm: (all kernels' ms, the port's kernels'
    ms) or (None, None)}."""
    out = {}
    for arm in arms:
        with torch.no_grad():
            dev_ms, port_ms, by_name = _device_ms(lambda: run(arm), 3)
        out[arm] = (dev_ms, port_ms)
        if dev_ms is None:
            print(f"{name} phase 5 device ms per depth-{depth} chain at M={m}, {arm}: not measured")
            continue
        top = ", ".join(f"{t:.4f} {k[:60]}" for k, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:3])
        print(f"{name} phase 5 device ms per depth-{depth} chain at M={m}, {arm}: {dev_ms:.4f} (the port's "
              f"kernels {port_ms:.4f}; largest: {top})", flush=True)
    return out


def run_wstream(batches, reps, depth, dev, ops, counts_api):
    """The ported wstream_bench tool at the DeiT-S GEMMs, M = 197·batch."""
    from p2vit_tpu_torch.tools import _gemm_bench as gb
    from p2vit_tpu_torch.tools import wstream_bench as wsb

    reset_launch_counts, launch_counts = counts_api
    mw, name = ops.matmul_wstream, "wstream"
    ms = [197 * b for b in batches]
    mism = {f: 0 for f in mw.FORMATS}
    wide = {f: 0 for f in mw.FORMATS}
    worst = 0.0
    rows = []
    for m in ms:
        rng = np.random.RandomState(m)
        for gname, k, n, gelu in (*gb.DEIT_S_GEMMS, gb.CONTROL):
            x, w, r, b = wsb.gemm_case(m, k, n, rng, dev)
            xw = wsb.wide_span_x(m, k, WIDE_SPAN, rng, dev)
            wb = w.to(torch.bfloat16)
            for fmt in mw.FORMATS:
                store = wsb.PACK[fmt](w)
                nn, e = _diff(mw.wstream_matmul(x, store, r, b, fmt, gelu),
                              mw.wstream_matmul_plain(x, store, r, b, fmt, gelu))
                mism[fmt] += nn
                worst = max(worst, e)
                wide[fmt] += _diff(mw.wstream_matmul(xw, store, r, b, fmt, gelu),
                                   mw.wstream_matmul_plain(xw, store, r, b, fmt, gelu))[0]
                if m == ms[-1] and gname != gb.CONTROL[0]:
                    rows.append((mw.wstream_matmul, mw.wstream_matmul_plain, (x, store, r, b),
                                 dict(w_format=fmt, gelu=gelu), depth,
                                 f"{name} phase 5 kernel wstream_matmul {fmt} {gname} M={m}",
                                 # the one PyTorch call: the bf16 GEMM over the same codes
                                 lambda x=x, wb=wb: torch.matmul(x, wb.T)))
    torch.cuda.synchronize()
    print(f"{name} phase 1 wstream_matmul vs plain (the tool's constants at M={ms}, 5 GEMMs): "
          f"mismatches {json.dumps(mism)}; on a {WIDE_SPAN}-binade x {json.dumps(wide)}", flush=True)
    if any(mism.values()) or any(wide.values()):
        _fail(f"{name}: wstream_matmul disagrees with its plain version: {mism}, wide-span {wide}")

    cases = [wsb.chain_case(m, m + 1, depth, dev) for m in ms]
    reset_launch_counts()
    outs = {fmt: [wsb.chain(fmt, x, layers, wsb.chain_stores(fmt, layers)) for x, layers in cases]
            for fmt in mw.FORMATS}
    torch.cuda.synchronize()
    counts = launch_counts()
    lib = [wsb.chain("library", x, layers, wsb.chain_stores("library", layers)) for x, layers in cases]
    agree = {fmt: [round(float((o.argmax(1) == l.argmax(1)).float().mean()), 4) for o, l in zip(outs[fmt], lib)]
             for fmt in mw.FORMATS}
    print(f"{name} phase 2 depth-{depth} chain at M={ms}: per-row argmax agreement with the library "
          f"chain {json.dumps(agree)}", flush=True)
    per_chain = 4 * depth
    want = {kk: 0 for kk in counts}
    want["wstream_matmul"] = per_chain * len(ms) * len(mw.FORMATS)
    print(f"{name} phase 3 launches over {len(ms)} chain calls per store: {json.dumps(counts)} "
          f"({per_chain} per chain call)", flush=True)
    if counts != want:
        _fail(f"{name}: launch counts {counts} != {want}")

    for m in ms:
        print(f"{name} phase 5 DeiT-S GEMMs at M={m} (tool lines)")
        rng = np.random.RandomState(m)
        for gname, k, n, gelu in (*gb.DEIT_S_GEMMS, gb.CONTROL):
            wsb.run_gemm(gname, m, k, n, gelu, rng, reps, dev)
        wsb.run_depth_chain(m, m + 1, max(2, reps // 4), depth, dev)

    res = _timed_rows("wstream_matmul", rows, reps)
    x, layers = cases[-1]
    stores = {arm: wsb.chain_stores(arm, layers) for arm in ("library", *mw.FORMATS)}
    dev_ms = _chain_device_ms(name, ("library", *mw.FORMATS),
                              lambda arm: wsb.chain(arm, x, layers, stores[arm]), depth, ms[-1])
    print_wstream_rates(name, mw, wsb, gb, dev_ms, depth, ms, reps, dev)
    res.update(launches=counts["wstream_matmul"], max_abs_err=worst,
               device_ms=None if any(v[0] is None for v in dev_ms.values())
               else sum(dev_ms[f][0] for f in mw.FORMATS))
    return {"wstream_matmul": res}


def print_wstream_rates(name, mw, wsb, gb, dev_ms, depth, ms, reps, dev):
    """wstream_matmul's rate against the float64 tensor-core peak: fc1 at
    the largest M per store (CUDA events), each store's chain (the port's
    kernels' device ms), and the blocks each GEMM launches at M = 197."""
    from p2vit_tpu_torch.ops import _lib

    rates = []
    probe_out = torch.empty(132 * 4 * 256, dtype=torch.float64, device=dev)
    for label, shape, mnk, iters in (("m8n8k4", 884, 8 * 8 * 4, 2000), ("m16n8k16", 16816, 16 * 8 * 16, 500)):
        t = _time_ms(lambda: _lib.launch("p2v_dmma_rate_probe", shape, probe_out, 132 * 4, iters), 3)
        rates.append(f"{label} {132 * 4 * 8 * iters * 8 * 2 * mnk / t / 1e9:.2f} TFLOP/s")
    print(f"{name} phase 5 float64 tensor-core throughput (csrc/dmma_probe.cu, register operands): "
          f"{', '.join(rates)}", flush=True)
    m = ms[-1]
    _, k, n, gelu = next(g for g in gb.DEIT_S_GEMMS if g[0] == "fc1")
    x, w, r, b = wsb.gemm_case(m, k, n, np.random.RandomState(m), dev)
    flops = 2 * m * k * n
    parts = []
    for fmt in mw.FORMATS:
        store = wsb.PACK[fmt](w)
        t = _time_ms(lambda: mw.wstream_matmul(x, store, r, b, fmt, gelu), reps)
        parts.append(f"{fmt} {t:.4f} ms {flops / t / 1e9:.2f} TFLOP/s ({flops / t / 1e9 / (F64_TC_FLOPS_S / 1e12):.3f} "
                     f"of peak)")
    print(f"{name} phase 5 wstream_matmul fc1 at M={m} ({flops / 1e9:.2f} GFLOP) against the "
          f"{F64_TC_FLOPS_S / 1e12:.0f} TFLOP/s float64 tensor-core peak: {'; '.join(parts)}", flush=True)
    chain_flops = depth * sum(2 * m * kk * nn for _, kk, nn, _ in gb.DEIT_S_GEMMS)
    ceiling = chain_flops / F64_TC_FLOPS_S * 1e3
    parts = [f"{fmt} not measured" if dev_ms[fmt][1] is None else
             f"{fmt} {dev_ms[fmt][1]:.4f} ms {chain_flops / dev_ms[fmt][1] / 1e9:.2f} TFLOP/s "
             f"({ceiling / dev_ms[fmt][1]:.3f} of peak)" for fmt in mw.FORMATS]
    print(f"{name} phase 5 wstream_matmul per depth-{depth} chain at M={m} ({chain_flops / 1e9:.1f} GFLOP, "
          f"float64 tensor-core ceiling {ceiling:.4f} ms): {'; '.join(parts)}", flush=True)
    blocks = {g: mw.wstream_blocks(197, nn) for g, _, nn, _ in (*gb.DEIT_S_GEMMS, gb.CONTROL)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{name} phase 5 wstream_matmul blocks at M=197 on {sms} SMs: {json.dumps(blocks)}", flush=True)


# ---------------------------------------------------------------------------
# The cli path: the port's CLI in process, on a folder of images it writes
# ---------------------------------------------------------------------------

CLI_TRAIN = (4, 16)  # classes × images: 64, two calibration batches of 32
CLI_VAL = (4, 34)  # 136 images: val batches of 64, 64 and a short 8
CLI_HW = (256, 320)  # image height, width (resized to 256 × 292, crop 224)


def _write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG written with zlib and struct only (no image library)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 per row

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _seeded_image(rng) -> np.ndarray:
    """A blocky seeded image with pixel noise, CLI_HW, uint8 HWC."""
    h, w = CLI_HW
    base = np.repeat(np.repeat(rng.randint(0, 256, (h // 32, w // 32, 3)), 32, 0), 32, 1)
    return np.clip(base + rng.randint(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def write_image_folder(root: str, seed: int) -> None:
    """train/ and val/ in the ImageFolder layout, seeded PNGs."""
    import os

    rng = np.random.RandomState(seed)
    for split, (classes, per) in (("train", CLI_TRAIN), ("val", CLI_VAL)):
        for c in range(classes):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(per):
                _write_png(os.path.join(d, f"{i:03d}.png"), _seeded_image(rng))


class _SeededImages:
    """The folder's stand-in where the machine has no decoder: seeded uint8
    images of the crop size, normalized on the host unless ``raw``."""

    def __init__(self, n, classes, size, seed, raw, mean, std):
        self.n, self.classes, self.size, self.seed, self.raw = n, classes, size, seed, raw
        self.mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(3, 1, 1)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        u8 = np.random.RandomState(self.seed * 100003 + i).randint(0, 256, (3, self.size, self.size)).astype(np.uint8)
        img = u8 if self.raw else (u8.astype(np.float32) / np.float32(255.0) - self.mean) / self.std
        return img, i % self.classes


def decode_route() -> str:
    """How this machine decodes the folder: the port's native loader if it
    builds, else PIL, else none."""
    from p2vit_tpu_torch import native

    if native.available():
        return "native"
    try:
        import PIL  # noqa: F401
    except ImportError:
        return "none"
    return "PIL"


def _vit_state_dict(params, cfg) -> dict:
    """The timm/DeiT layout of the port's ViT params (a ``--checkpoint``)."""
    c, ps = cfg.embed_dim, cfg.patch_size
    sd = {"cls_token": params["cls_token"], "pos_embed": params["pos_embed"],
          "patch_embed.proj.weight": params["patch_embed"]["w"].reshape(c, cfg.in_chans, ps, ps),
          "patch_embed.proj.bias": params["patch_embed"]["b"], "norm.weight": params["norm"]["w"],
          "norm.bias": params["norm"]["b"], "head.weight": params["head"]["w"], "head.bias": params["head"]["b"]}
    names = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}
    for i, blk in enumerate(params["blocks"]):
        for key, name in names.items():
            sd[f"blocks.{i}.{name}.weight"] = blk[key]["w"]
            sd[f"blocks.{i}.{name}.bias"] = blk[key]["b"]
    return {"model": {k: v.detach().cpu().contiguous() for k, v in sd.items()}}


def _non_pot_scales(qstate) -> str:
    """How many of the state's layer-wise activation scales (every node's
    but the PTF nodes' per-channel ones) are not powers of two."""
    found = []

    def walk(node, key=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, key)
        elif isinstance(node, torch.Tensor) and (key == "qact0_scale" or (key == "scale" and node.ndim == 0)):
            found.extend(node.reshape(-1).tolist())

    walk(qstate)
    non_pot = sum(1 for v in found if not _is_pot(v))
    return f"{non_pot} of {len(found)} layer-wise activation scales are not powers of two"


def _cli_run(label, argv, route, dev, smi, counts_api):
    """The CLI's own steps (``p2vit_tpu_torch.cli.main``'s) on ``argv``,
    with every val batch seen; then each batch's logits against
    ``serving_forward`` on the same state and images, and against its plain
    path (``use_kernels=False``, bitwise), Prec@1/5 against ``accuracy`` on
    those logits, the launch counts of the val loop against
    ``launches_per_forward``, and host ms per batch. Returns the logits."""
    from p2vit_tpu_torch import cli, serving, serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import MODEL_ZOO, PREPROCESS, swin, vit

    reset_launch_counts, launch_counts = counts_api
    args = cli.build_parser().parse_args(argv)
    cfg = MODEL_ZOO[cli.FULL_NAME[args.model]]
    is_swin = args.model.startswith("swin")
    family = swin if is_swin else vit
    policy = make_policy(args.ptf, args.lis, args.quant_method)
    pp = PREPROCESS[args.model.split("_")[0]]
    u8 = args.u8_ingest
    orig_make_dataset = cli.make_dataset
    if route == "none":  # the device half over seeded images in place of the decoded folder
        def seeded(a, c, split, raw=False):
            n, k = (CLI_TRAIN[0] * CLI_TRAIN[1], CLI_TRAIN[0]) if split == "train" else (CLI_VAL[0] * CLI_VAL[1],
                                                                                          CLI_VAL[0])
            return _SeededImages(n, k, c.img_size, a.seed + (split == "val"), raw, pp["mean"], pp["std"])
        cli.make_dataset = seeded
    try:
        t0 = time.time()
        params = cli.load_model(args, cfg, family, dev)
        calib = cli.calibrate_or_load(args, cfg, family, params, policy, dev)
        torch.cuda.synchronize()
        t_calib = time.time() - t0
        val = cli.make_dataset(args, cfg, "val", raw=u8)
        model_fn = cli.build_model_fn(args, cfg, family, params, calib, policy, u8)
        torch.cuda.synchronize()
        t_setup = time.time() - t0
        seen = []
        bits = [4] * cfg.num_matmuls
        reset_launch_counts()
        p1, p5 = cli.validate(args, val, model_fn, bits, dev,
                              on_batch=lambda i, imgs, t, lg, w, f: seen.append((imgs, t, lg, w, f)))
        counts = launch_counts()
    finally:
        cli.make_dataset = orig_make_dataset
    if not seen:
        _fail(f"cli {label}: no val batch")
    # the same state and images through serving_forward
    s = (serving_swin if is_swin else serving).convert(params, calib.qstate, cfg, policy, bits)
    if u8:
        (serving_swin if is_swin else serving).attach_u8_ingest(s, pp["mean"], pp["std"])
    differ = differ_plain = 0
    for imgs, _, lg, _, _ in seen:
        x = torch.from_numpy(imgs).to(dev)
        for kernels in (True, False):
            ref = (serving_swin.serving_forward(s, calib.qstate, cfg, policy, x, use_kernels=kernels) if is_swin
                   else serving.serving_forward(s, cfg, x, lis=policy.int_softmax, use_kernels=kernels))
            n = int((ref.cpu().numpy() != lg).sum())
            differ, differ_plain = (differ + n, differ_plain) if kernels else (differ, differ_plain + n)
    logits = np.concatenate([b[2] for b in seen])
    targets = np.concatenate([b[1] for b in seen])
    r1, r5 = cli.accuracy(logits, targets, topk=(1, 5))
    per_forward = (serving_swin if is_swin else serving).launches_per_forward(cfg)
    want = {k: v * len(seen) for k, v in per_forward.items()}
    got = {k: v for k, v in counts.items() if v}
    sizes = [len(b[1]) for b in seen]
    print(f"cli {label}: setup (load, calibrate or load the quant state, datasets) {t_setup:.1f} s, of it "
          f"load and calibration {t_calib:.1f} s; {len(seen)} val batches of {sizes} images, decode {route}; "
          f"{_non_pot_scales(calib.qstate)}", flush=True)
    print(f"cli {label}: logits against serving_forward on the same state and images: {differ} of "
          f"{logits.size} differ; against its plain path (use_kernels=False): {differ_plain} differ; all "
          f"finite {bool(np.isfinite(logits).all())}", flush=True)
    print(f"cli {label}: Prec@1 {p1:.6f} Prec@5 {p5:.6f}; recomputed by accuracy from the logits "
          f"{r1:.6f} {r5:.6f}", flush=True)
    print(f"cli {label}: launches over {len(seen)} forwards {json.dumps(got)}; launches_per_forward × "
          f"{len(seen)} {json.dumps(want)}", flush=True)
    waits, fwds = [1e3 * b[3] for b in seen], [1e3 * b[4] for b in seen]
    print(f"cli {label}: host ms per val batch, wait on the prefetch queue {[round(w, 3) for w in waits]}, "
          f"forward to logits on the host {[round(f, 3) for f in fwds]} (batch 0's forward builds the "
          f"serving state); past batch 0 the wait is {sum(waits[1:]) / max(sum(waits[1:]) + sum(fwds[1:]), 1e-9):.3f} "
          f"of the loop; card {smi}", flush=True)
    if differ or differ_plain:
        _fail(f"cli {label}: {differ} logits differ from serving_forward, {differ_plain} from its plain path")
    if abs(p1 - r1) > 1e-9 or abs(p5 - r5) > 1e-9:
        _fail(f"cli {label}: Prec@1/5 {p1}, {p5} against {r1}, {r5} recomputed")
    if got != want:
        _fail(f"cli {label}: launches {got} against {want}")
    if not np.isfinite(logits).all() or logits.shape != (sum(sizes), cfg.num_classes):
        _fail(f"cli {label}: logits not finite or of shape {logits.shape}")
    return logits


def _cli_search_run(label, argv, route, dev, smi, counts_api):
    """``--mixed`` through the CLI's own steps: calibration, the
    sensitivities (live Hessian traces, timed), ``mixed_search`` with every
    validation timed and split into the wait on the decode queue and the
    forward; then the best config's logits on the first val batch through
    the CLI's serving state against the plain path (bitwise) and its launch
    counts against ``launches_per_forward``."""
    from p2vit_tpu_torch import cli, serving
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import MODEL_ZOO, vit

    reset_launch_counts, launch_counts = counts_api
    args = cli.build_parser().parse_args(argv)
    cfg = MODEL_ZOO[cli.FULL_NAME[args.model]]
    policy = make_policy(args.ptf, args.lis, args.quant_method)
    if route == "none":
        _fail(f"cli {label}: no image decoder on this machine")
    t0 = time.time()
    params = cli.load_model(args, cfg, vit, dev)
    calib = cli.calibrate_or_load(args, cfg, vit, params, policy, dev)
    val = cli.make_dataset(args, cfg, "val")
    model_fn = cli.build_model_fn(args, cfg, vit, params, calib, policy, False)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    t0 = time.time()
    mean_hessian = cli.sensitivities(args, cfg, params, dev)
    torch.cuda.synchronize()
    t_hessian = time.time() - t0
    runs, first = [], []

    def validate_fn(bits):
        waits, fwds = [], []

        def seen(i, imgs, targets, logits, wait_s, fwd_s):
            waits.append(wait_s)
            fwds.append(fwd_s)
            if not first:
                first.append(imgs)

        t = time.perf_counter()
        out = cli.validate(args, val, model_fn, bits, dev, on_batch=seen)
        runs.append((time.perf_counter() - t, sum(waits), sum(fwds)))
        return out

    t0 = time.time()
    front, result = cli.mixed_search(args, cfg, False, calib, mean_hessian, validate_fn)
    t_search = time.time() - t0
    total, wait, fwd = (sum(r[i] for r in runs) for i in range(3))
    print(f"cli {label}: setup (load, calibration over {args.calib_iter} batches, datasets) {t_setup:.1f} s; "
          f"live Hessian traces over {args.hessian_batches} batch of {args.calib_batchsize} images "
          f"{t_hessian:.2f} s; card {smi}", flush=True)
    print(f"cli {label}: Pareto front {len(front)} configs; {len(runs)} configs validated in {t_search:.1f} s, "
          f"{total / max(len(runs), 1):.3f} s per validation ({args.limit_val} val batch of "
          f"{args.val_batchsize}); of the validations' time the wait on the decode queue is "
          f"{wait / max(total, 1e-9):.3f} and the forward (with each new config's convert) "
          f"{fwd / max(total, 1e-9):.3f}", flush=True)
    for bits, prec1 in result[:5]:
        print(f"cli {label}: best config {bits} Prec@1 {prec1:.6f} "
              f"({sum(b == 8 for b in bits)} of {len(bits)} layers at 8 bits)", flush=True)
    best = result[0][0]
    x = torch.from_numpy(first[0]).to(dev)
    reset_launch_counts()
    got = model_fn(x, best)
    counts = {k: v for k, v in launch_counts().items() if v}
    s = serving.convert(params, calib.qstate, cfg, policy, best)
    want = serving.serving_forward(s, cfg, x, lis=policy.int_softmax, use_kernels=False)
    n_bad = int((got != want).sum())
    per_forward = serving.launches_per_forward(cfg)
    print(f"cli {label}: best mixed config's logits on val batch 0 against the plain path: {n_bad} of "
          f"{got.numel()} differ; launches {json.dumps(counts)} against {json.dumps(per_forward)}", flush=True)
    if n_bad:
        _fail(f"cli {label}: the best mixed config's logits differ from the plain path in {n_bad} places")
    if counts != per_forward:
        _fail(f"cli {label}: launches {counts} against {per_forward}")
    if 8 not in best[1:]:
        print(f"cli {label}: note: the best config holds no 8-bit layer past the patch embedding", flush=True)


def run_cli_path(dev, smi, seed, counts_api):
    """The ``cli`` path: a folder of seeded PNGs and a ``.pth`` of the seeded
    DeiT-S params; the CLI at full width with ``--quant --serve`` on DeiT-S
    (saving the quant state), then ``--u8-ingest`` on the saved state, then
    the state reloaded (logits against the first run's), then Swin-T, then
    ViT-B (the vit family's crop 0.9 and mean = std = 0.5); then DeiT-S
    calibrated over two batches by omse (activation scales that are
    not powers of two), the mixed-precision search on DeiT-S with live
    Hessian traces, and Swin-T calibrated over two batches by percentile."""
    import os
    import tempfile

    from p2vit_tpu_torch.models import MODEL_ZOO, vit

    route = decode_route()
    print("cli decode: none on this machine" if route == "none" else f"cli decode: {route}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.time()
        if route != "none":
            write_image_folder(data, seed)
        pth, q = os.path.join(tmp, "deit_small.pth"), os.path.join(tmp, "deit_small_quant.npz")
        cfg = MODEL_ZOO["deit_small_patch16_224"]
        torch.save(_vit_state_dict(vit.init_params(seed, cfg, device=dev), cfg), pth)
        print(f"cli: wrote {CLI_TRAIN[0] * CLI_TRAIN[1] + CLI_VAL[0] * CLI_VAL[1] if route != 'none' else 0} "
              f"images of {CLI_HW} and the checkpoint in {time.time() - t0:.1f} s", flush=True)
        common = ["--quant", "--serve", "--calib-batchsize", "32", "--val-batchsize", "64", "--limit-val", "3",
                  "--seed", str(seed), "--print-freq", "1"] + (["--native-loader"] if route == "native" else [])
        deit = ["deit_small", data, "--checkpoint", pth] + common
        first = _cli_run("deit_small", deit + ["--save-quant-state", q], route, dev, smi, counts_api)
        _cli_run("deit_small --u8-ingest (loaded state)", deit + ["--u8-ingest", "--load-quant-state", q], route,
                 dev, smi, counts_api)
        again = _cli_run("deit_small --load-quant-state", deit + ["--load-quant-state", q], route, dev, smi,
                         counts_api)
        n_re = int((first != again).sum())
        print(f"cli deit_small: logits after the quant-state reload against the first run: {n_re} of "
              f"{first.size} differ", flush=True)
        if n_re:
            _fail(f"cli: {n_re} logits differ after the quant-state reload")
        if route != "none":  # main itself: one process, then --tp 2 over two ranks on this card
            from p2vit_tpu_torch import cli

            t0 = time.time()
            single = cli.main(deit + ["--load-quant-state", q])
            t1 = time.time()
            tp2 = cli.main(deit + ["--load-quant-state", q, "--tp", "2"], timeout_s=300)
            print(f"cli deit_small --tp 2 (2 ranks on one card, gloo through the host): Prec@1/5 {tp2} against "
                  f"{single} in one process; {time.time() - t1:.1f} s against {t1 - t0:.1f} s ({smi})", flush=True)
            if tp2 != single:
                _fail(f"cli: --tp 2 gives Prec@1/5 {tp2}, one process {single}")
        _cli_run("swin_tiny", ["swin_tiny", data, "--random-init"] + common, route, dev, smi, counts_api)
        # the vit family's preprocessing (crop 0.9, mean = std = 0.5): nowhere else on the card
        _cli_run("vit_base", ["vit_base", data, "--random-init"] + common, route, dev, smi, counts_api)
        two = ["--calib-iter", "2"]
        _cli_run("deit_small --calib-iter 2 --quant-method omse", deit + two + ["--quant-method", "omse"], route,
                 dev, smi, counts_api)
        t0 = time.time()
        search = ["--calib-iter", "2", "--mixed", "--live-hessian", "--hessian-batches", "1", "--limit-val", "1",
                  "--print-freq", "1000"]
        _cli_search_run("deit_small --mixed --live-hessian", deit + search, route, dev, smi, counts_api)
        print(f"cli deit_small --mixed --live-hessian: the run in {time.time() - t0:.1f} s", flush=True)
        _cli_run("swin_tiny --calib-iter 2 --quant-method percentile",
                 ["swin_tiny", data, "--random-init"] + common + two + ["--quant-method", "percentile"], route,
                 dev, smi, counts_api)


class _Generation:
    """``datafree.generate_data`` timed: each call's seconds, Adam steps,
    peak memory (``torch.cuda.max_memory_allocated`` from a reset at its
    start), and the three loss terms of its first and last step."""

    def __init__(self, real):
        self.real, self.runs = real, []

    def __call__(self, *a, **k):
        terms, steps = {}, [0]

        def on_step(epoch, it, t):
            terms.setdefault("first", t)
            terms["last"] = t  # tensors: no sync a step
            steps[0] += 1

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = self.real(*a, **k, on_step=on_step)
        torch.cuda.synchronize()
        self.runs.append(dict(s=time.time() - t0, steps=steps[0], peak=torch.cuda.max_memory_allocated(),
                              batch=out.shape[0], finite=bool(torch.isfinite(out).all()),
                              first=[round(float(v), 6) for v in terms["first"]],
                              last=[round(float(v), 6) for v in terms["last"]]))
        return out

    def report(self, label, smi, want_steps) -> None:
        r = self.runs[-1]
        print(f"datafree {label}: {r['steps']} Adam steps at batch {r['batch']} in {r['s']:.2f} s, "
              f"{r['steps'] / r['s']:.2f} steps/s; peak memory {r['peak'] / 2**30:.3f} GiB; loss terms "
              f"(-entropy, cross-entropy, |TV - target|) first step {r['first']}, last step {r['last']}; "
              f"images finite {r['finite']}; card {smi}", flush=True)
        if r["steps"] != want_steps or not r["finite"]:
            _fail(f"datafree {label}: {r['steps']} steps (want {want_steps}), images finite {r['finite']}")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def run_datafree_path(dev, smi, seed, counts_api):
    """The ``datafree`` path: DeiT-S through the CLI with ``--mode 2`` (the
    2 × 500 Adam steps of ``generate_data`` at batch 32, then calibration
    and serving, held as the ``cli`` path holds its runs); Swin-T's
    ``generate_data(iterations_per_epoch=25)`` called directly, calibrated,
    converted (W4) and served at batch 64 bitwise against its plain path,
    with its launch counts; and ``--plot`` on DeiT-S: ``collect_activations``
    on the card against the same call on the CPU (1e-4 relative a tensor:
    float32 GEMMs in another order), the SVGs written only where
    matplotlib imports."""
    import importlib.util
    import os
    import tempfile

    from p2vit_tpu_torch import analysis, cli, datafree, serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import MODEL_ZOO, swin, vit

    reset_launch_counts, launch_counts = counts_api
    route = decode_route()
    gen = _Generation(datafree.generate_data)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        if route != "none":
            write_image_folder(data, seed)
        pth = os.path.join(tmp, "deit_small.pth")
        cfg = MODEL_ZOO["deit_small_patch16_224"]
        torch.save(_vit_state_dict(vit.init_params(seed, cfg, device=dev), cfg), pth)
        deit = ["deit_small", data, "--checkpoint", pth, "--quant", "--serve", "--calib-batchsize", "32",
                "--val-batchsize", "64", "--limit-val", "3", "--seed", str(seed), "--print-freq", "1"] + (
            ["--native-loader"] if route == "native" else [])
        datafree.generate_data = gen
        try:
            t0 = time.time()
            _cli_run("deit_small --mode 2", deit + ["--mode", "2"], route, dev, smi, counts_api)
            print(f"datafree deit_small --mode 2: the CLI run in {time.time() - t0:.1f} s", flush=True)
            gen.report("deit_small --mode 2 (2 x 500 steps, lr 0.2)", smi, 1000)

            scfg = MODEL_ZOO["swin_tiny_patch4_window7_224"]
            policy = make_policy()
            params = swin.init_params(seed, scfg, device=dev)
            imgs = datafree.generate_data(params, scfg, batch_size=32, seed=seed, iterations_per_epoch=25)
        finally:
            datafree.generate_data = gen.real
        gen.report("swin_tiny generate_data(iterations_per_epoch=25)", smi, 50)
        t0 = time.time()
        calib = swin.calibrate(params, scfg, policy, imgs)
        s = serving_swin.convert(params, calib.qstate, scfg, policy, 4)
        x = torch.randn((64, 3, 224, 224), generator=torch.Generator().manual_seed(seed + 9)).to(dev)
        reset_launch_counts()
        got = serving_swin.serving_forward(s, calib.qstate, scfg, policy, x)
        counts = {k: v for k, v in launch_counts().items() if v}
        want = serving_swin.serving_forward(s, calib.qstate, scfg, policy, x, use_kernels=False)
        n_bad, per_forward = int((got != want).sum()), serving_swin.launches_per_forward(scfg)
        print(f"datafree swin_tiny: calibrated on the generated batch, W4, batch 64 served in "
              f"{time.time() - t0:.1f} s: {n_bad} of {got.numel()} logits differ from the plain path; finite "
              f"{bool(torch.isfinite(got).all())}; launches {json.dumps(counts)} against "
              f"{json.dumps(per_forward)}", flush=True)
        if n_bad or counts != per_forward or not bool(torch.isfinite(got).all()):
            _fail(f"datafree swin_tiny: {n_bad} logits differ, launches {counts} against {per_forward}")

        args = cli.build_parser().parse_args(deit + ["--plot"])
        params = cli.load_model(args, cfg, vit, dev)
        seen = []
        real = analysis.collect_activations
        analysis.collect_activations = lambda p, c, xx, **k: seen.append((xx, real(p, c, xx, **k))) or seen[-1][1]
        orig_make_dataset = cli.make_dataset
        if route == "none":
            cli.make_dataset = lambda a, c, split, raw=False: _SeededImages(
                CLI_VAL[0] * CLI_VAL[1], CLI_VAL[0], c.img_size, a.seed + 1, raw, MEAN, STD)
        cwd = os.getcwd()
        try:
            val = cli.make_dataset(args, cfg, "val")
            if importlib.util.find_spec("matplotlib") is not None:
                os.chdir(tmp)
                paths = cli.plot_activations(args, cfg, False, params, val, False, dev)
                svgs = sum(os.path.exists(os.path.join(tmp, p)) for p in paths)
                print(f"datafree deit_small --plot: {svgs} SVGs written", flush=True)
                if svgs != 7:
                    _fail(f"--plot wrote {svgs} SVGs, not 7")
            else:
                print("datafree deit_small --plot: matplotlib is absent on this machine; no SVGs written, the "
                      "activations collected alone", flush=True)
                imgs8 = torch.from_numpy(np.stack([val[i][0] for i in range(8)])).to(dev)
                analysis.collect_activations(params, cfg, imgs8)
        finally:
            os.chdir(cwd)
            analysis.collect_activations = real
            cli.make_dataset = orig_make_dataset
        xx, acts = seen[0]
        cpu = real(_cast_tree(params, "cpu"), cfg, xx.cpu())
        errs = {k: _rel(acts[k].cpu(), cpu[k]) for k in acts}
        print(f"datafree deit_small --plot: collect_activations on the card against the CPU, relative error a "
              f"tensor {json.dumps({k: round(v, 9) for k, v in errs.items()})} ({len(acts)} tensors of "
              f"{xx.shape[0]} images)", flush=True)
        if len(acts) != 7 or max(errs.values()) > 1e-4:
            _fail(f"--plot activations: {len(acts)} tensors, largest relative error {max(errs.values())}")


def run_plan_path(dev, smi, batches, iters):
    """The ``plan`` path: the port's ``latency_ab`` sweep at DeiT-T, DeiT-S
    and Swin-T over ``batches`` (``iters`` forwards a window); the table in
    ms per forward (CUDA events), device ms (profiler) and img/s; every
    int8 arm's logits at each (model, batch) against its plain path
    (bitwise), its launches of one forward against ``launches_per_forward``
    and the fused layer's logits against the default's (bitwise), any
    difference failing; and for each (model, batch) whether
    ``plan.recommend(prefer_exact=False)`` names the arm measured fastest
    (a disagreement is printed, not failed: near a crossover the two arms
    are within noise)."""
    from p2vit_tpu_torch import plan
    from p2vit_tpu_torch.models import MODEL_ZOO
    from p2vit_tpu_torch.tools import latency_ab

    names = ["deit_tiny_patch16_224", "deit_small_patch16_224", "swin_tiny_patch4_window7_224"]
    print(f"plan: the table of p2vit_tpu_torch/plan.py: INT8_MIN_BATCH {plan.INT8_MIN_BATCH}, VIT_MIN_EMBED_DIM "
          f"{plan.VIT_MIN_EMBED_DIM}, INT8_FLAGS {plan.INT8_FLAGS}, FASTEST_LIS {plan.FASTEST_LIS}", flush=True)
    res = latency_ab.run(names, batches, dev, iters=iters, reps=1)
    agree = 0
    for key, row in res.items():
        name, b = key.split("@b")
        b = int(b)
        arms = [k[:-3] for k in row if k.endswith("_ms") and not k.endswith("_dev_ms")]
        checked = [a for a in arms if a + "_bad" in row]
        bad = {a: row[a + "_bad"] for a in checked}
        wrong = {a: (row[a + "_launches"], row[a + "_launches_want"]) for a in checked
                 if row[a + "_launches"] != row[a + "_launches_want"]}
        print(f"plan check {name} batch {b}: logits differing from the plain path (use_kernels=False, same flags) "
              f"{json.dumps(bad)} of {b * MODEL_ZOO[name].num_classes} each; launches of one forward against "
              f"launches_per_forward {'all equal' if not wrong else json.dumps(wrong)}; fused layer bitwise "
              f"against the default {row.get('fl_bitwise', 'no fused-layer arm')}", flush=True)
        if any(bad.values()) or wrong or row.get("fl_bitwise") is False or len(checked) < 2:
            _fail(f"plan {name} batch {b}: differing {bad}, launches {wrong}, fl_bitwise {row.get('fl_bitwise')}")
        dev_ms = lambda a: "not measured" if row[a + "_dev_ms"] is None else f"{row[a + '_dev_ms']:.4f} ms"  # noqa: E731
        print(f"plan table {name} batch {b}: " + "; ".join(
            f"{a} {row[a + '_ms']:.4f} ms / device {dev_ms(a)} / {b / row[a + '_ms'] * 1e3:.1f} img/s"
            for a in arms) + f"; fastest {row['best']}; card {smi}", flush=True)
        rec = plan.recommend(MODEL_ZOO[name], b, prefer_exact=False)
        named = latency_ab.arm_of(rec)
        ok = named == row["best"] or (rec.path == "bf16" and row["best"] in ("bf16", "wonly"))
        agree += ok
        print(f"plan {name} batch {b}: recommend(prefer_exact=False) -> {named} (path {rec.path}, lis {rec.lis}); "
              f"measured fastest {row['best']}: {'agrees' if ok else 'DISAGREES'}; recommend(prefer_exact=True) "
              f"-> {latency_ab.arm_of(plan.recommend(MODEL_ZOO[name], b))}", flush=True)
    print(f"plan: recommend agrees with the measured fastest arm at {agree} of {len(res)} (model, batch) points",
          flush=True)
    calibrated_arm_checks(dev, names[:2], max(batches), latency_ab)


def calibrated_arm_checks(dev, names, batch, latency_ab):
    """Every ViT int8 arm of ``latency_ab`` at ``batch`` on a calibrated W8
    state (calibrated on the first 32 of the batch's images): logits bitwise
    against the plain path at the same flags and the launches of one
    forward against ``launches_per_forward``; any difference fails. The
    sweep's ``synthetic_qstate`` leaves most codes zero (every [CLS] row),
    so its logits see little of the kernels' work."""
    from p2vit_tpu_torch import serving
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import MODEL_ZOO, vit
    from p2vit_tpu_torch.ops import launch_counts, reset_launch_counts

    policy = make_policy()
    for name in names:
        cfg = MODEL_ZOO[name]
        params = vit.init_params(0, cfg, device=dev)
        x = latency_ab._images(batch, cfg, dev)
        s = serving.convert(params, vit.calibrate(params, cfg, policy, x[:32]).qstate, cfg, policy,
                            [8] * cfg.num_matmuls)
        for arm, kw in latency_ab.VIT_ARMS.items():
            reset_launch_counts()
            got = serving.serving_forward(s, cfg, x, **kw)
            counts = {k: v for k, v in launch_counts().items() if v}
            want = serving.launches_per_forward(cfg, **{k: v for k, v in kw.items() if k != "lis"})
            n_bad = int((got != serving.serving_forward(s, cfg, x, use_kernels=False, **kw)).sum())
            print(f"plan check {name} batch {batch} {arm} on a calibrated W8 state: {n_bad} of {got.numel()} "
                  f"logits differ from the plain path; launches {'equal' if counts == want else counts}; "
                  f"finite {bool(torch.isfinite(got).all())}", flush=True)
            if n_bad or counts != want or not bool(torch.isfinite(got).all()):
                _fail(f"plan {name} batch {batch} {arm} calibrated: {n_bad} logits differ, launches {counts} "
                      f"against {want}")


def wide_stem_checks(dev, ops) -> None:
    """``fused_swin_stem`` past C = 256 (clusters of ⌈C/256⌉ CTAs): at C =
    384 and the largest C it serves, K = 48, M = 8·3136 + 77, on
    random-normal inputs and on a calibrated state's kinds (PTF masks up to
    16, a zero patch row): the kernel against its plain version (must be 0
    mismatches), the launch facts, and the kernel's ms per call beside the
    plain version's (CUDA events)."""
    st = ops.swin_stem
    m, k = 8 * 3136 + 77, 48
    for c in (384, st.MAX_STEM_C):
        rng = np.random.RandomState(c)
        bias = torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32))
        ln_w = torch.from_numpy(rng.randn(c).astype(np.float32))
        ln_b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
        cases = {"randn": (torch.from_numpy(rng.randn(m, k).astype(np.float32)),
                           torch.from_numpy((rng.randn(c, k) * 0.2).astype(np.float32)), bias,
                           torch.tensor(0.04), ln_w, ln_b, torch.tensor(0.03))}
        px = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.float32)) * 2.0**-5
        px[100] = 0
        w = (torch.from_numpy(rng.randint(-8, 8, (c, k)).astype(np.float32))
             * torch.from_numpy((2.0 ** rng.randint(-9, -6, c)).astype(np.float32))[:, None])
        cases["pot"] = (px, w, torch.zeros(c), torch.from_numpy((2.0**-4 * 2.0 ** rng.randint(0, 5, c)).astype(
            np.float32)), ln_w, ln_b, torch.tensor(2.0**-4))
        bad = {}
        for name, case in cases.items():
            a = [t.to(dev) for t in case]
            bad[name] = int((st.fused_swin_stem(*a) != st.fused_swin_stem_plain(*a)).sum())
        info = st.stem_kernel_info(m, k, c)
        t_k, t_p = _time_ms(lambda: st.fused_swin_stem(*a), 5), _time_ms(lambda: st.fused_swin_stem_plain(*a), 2)
        print(f"stem C={c}: kernel vs plain mismatches {json.dumps(bad)} over {m} x {c} codes; clusters of "
              f"{info['cs']} CTAs x {info['cc']} channels a thread ({info['c_pad']} padded), {info['grid']} CTAs "
              f"({info['clusters']} clusters resident), {info['smem_bytes']} B shared memory a CTA, "
              f"{info['registers']} registers ({info['spill_bytes']} B spilled); {t_k:.4f} ms per call against "
              f"the plain version's {t_p:.4f}", flush=True)
        if any(bad.values()):
            _fail(f"fused_swin_stem at C = {c}: {bad} codes differ from the plain version")


def tiny_swin_checks(dev, ops) -> None:
    """Phase 1 at the JAX tests' TINY Swin (embed 16, heads (2, 2), 4×4
    windows: head_dims 8 and 16, which the wrappers zero-pad to 32): both
    attention entries against their plain versions on the path's captured
    arguments, and serving_forward whole against the plain path, LIS on and
    off. Any difference fails."""
    from p2vit_tpu_torch import serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import swin

    cfg = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                          num_heads=(2, 2), window_size=4)
    al = ops.attention_lis
    for lis in (True, False):
        policy = make_policy(lis=lis)
        params = swin.init_params(3, cfg, device=dev)
        x = torch.randn((8, 3, 32, 32), generator=torch.Generator().manual_seed(4)).to(dev)
        calib = swin.calibrate(params, cfg, policy, x)
        s = serving_swin.convert(params, calib.qstate, cfg, policy, 4)
        fwd = lambda k: serving_swin.serving_forward(s, calib.qstate, cfg, policy, x, use_kernels=k)  # noqa: E731
        calls = _capture([al], ["swin_lis_attention_plain"], lambda: fwd(False))["swin_lis_attention_plain"]
        bad, dims = 0, set()
        for a, k in calls:
            dims.add(a[0].shape[-1] // 3 // a[3])
            bad += int((al.swin_lis_attention(*a, **k) != al.swin_lis_attention_plain(*a, **k)).sum())
            if a[4] == 4:  # stage 0's 2×2 windows: the folded entry on their raster grid
                raster = swin.window_reverse(a[0], 4, 8, 8).contiguous()
                for shift in (0, 2):
                    fa = (raster, a[1], a[2], a[3], 4) + tuple(a[5:])
                    bad += int((al.swin_lis_attention_folded(*fa, **k, shift=shift)
                                != al.swin_lis_attention_folded_plain(*fa, **k, shift=shift)).sum())
        got, want = fwd(True), fwd(False)
        n_bad = int((got != want).sum())
        print(f"phase 1 TINY Swin (head_dims {sorted(dims)}, padded to 32) LIS {'on' if lis else 'off'}: "
              f"attention entries vs plain mismatches {bad} over {len(calls)} calls; serving_forward vs plain "
              f"path {n_bad} of {got.numel()} logits differ", flush=True)
        if bad or n_bad or dims != {8, 16}:
            _fail(f"TINY Swin head_dims {sorted(dims)}, LIS {lis}: {bad} attention and {n_bad} logit mismatches")


def window12_checks(dev, ops) -> None:
    """Both Swin attention entries past 64 tokens a window: 12×12 windows
    (N = 144, the kernel's unstaged instance, keys padded to 160) of 8
    images on a 24×24 grid, 4 heads of 32, random codes and bias, against
    their plain versions: the panel entry without and with the shift mask,
    the folded entry at shift 0 and 6, LIS on and off; then at head_dim 16
    (zero-padded to 32). Prints the instance's launch facts and µs per call;
    any difference fails."""
    from p2vit_tpu_torch.models import swin

    al = ops.attention_lis
    b, res, ws, heads = 8, 24, 12, 4
    n, g = ws * ws, res // ws
    gen = torch.Generator().manual_seed(12)
    s2 = 2.0**-4
    mask = (torch.from_numpy(swin.shift_attn_mask(res, res, ws, ws // 2)) / s2).to(dev)
    scales = (2.0**-9, 2.0**-4, s2, 2.0**-2)
    for d in (32, 16):
        c = d * heads
        qkv = torch.randint(-128, 128, (b, res, res, 3 * c), generator=gen, dtype=torch.int8).to(dev)
        bias = (torch.randn((heads, n, n), generator=gen) * 0.3).to(dev)
        panels = swin.window_partition(qkv, ws).contiguous()
        for lis in (True, False):
            bad, calls = 0, 0
            for m in (None, mask):
                a = (panels, bias, m, heads, g * g, *scales)
                bad += int((al.swin_lis_attention(*a, lis=lis) != al.swin_lis_attention_plain(*a, lis=lis)).sum())
                calls += 1
            for shift in (0, ws // 2):
                fa = (qkv, bias, mask if shift else None, heads, ws, *scales)
                bad += int((al.swin_lis_attention_folded(*fa, lis=lis, shift=shift)
                            != al.swin_lis_attention_folded_plain(*fa, lis=lis, shift=shift)).sum())
                calls += 1
            info = al.swin_attention_info(n, lis)
            us = 1e3 * _time_ms(lambda: al.swin_lis_attention(panels, bias, mask, heads, g * g, *scales, lis=lis), 5)
            print(f"phase 1 Swin window 12×12 (N = {n}, head_dim {d}) LIS {'on' if lis else 'off'}: both entries vs "
                  f"plain mismatches {bad} over {calls} calls; instance NM {al.swin_instance_n(n)}, shared memory "
                  f"{info['smem_bytes']} B, registers {info['registers']}, spills {info['spill_bytes']} B, "
                  f"{info['ctas_per_sm']} CTAs per SM; {us:.1f} µs per panel call ({b * g * g * heads} items)",
                  flush=True)
            if bad:
                _fail(f"Swin attention at N = {n}, head_dim {d}, LIS {lis}: {bad} mismatches")
            if info["smem_bytes"] != al.swin_attention_smem(n, lis):
                _fail(f"Swin attention at N = {n}: {info['smem_bytes']} B of shared memory, the plan says "
                      f"{al.swin_attention_smem(n, lis)}")


_SASS: dict = {}


def start_sass(lib_path: str) -> None:
    """Start ``cuobjdump -sass`` of the built library in the background,
    its output to a temporary file (it takes ~40 s; ``_sass`` waits for it;
    the process is killed at exit if it still runs)."""
    import atexit
    import os
    import shutil
    import tempfile

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                     "cuobjdump")
    out = tempfile.TemporaryFile(mode="w+")
    try:
        proc = subprocess.Popen([tool, "-sass", lib_path], stdout=out, stderr=subprocess.DEVNULL, text=True)
    except OSError as e:  # no cuobjdump: the counts read "not measured"
        _SASS[lib_path] = e
        return
    atexit.register(proc.kill)
    _SASS[lib_path] = (proc, out)


def _sass(lib_path: str) -> str:
    """``cuobjdump -sass`` of the built library, run once (``start_sass``)
    and kept."""
    if lib_path not in _SASS:
        start_sass(lib_path)
    if isinstance(_SASS[lib_path], OSError):
        raise _SASS[lib_path]
    if isinstance(_SASS[lib_path], tuple):
        proc, out = _SASS[lib_path]
        proc.wait(timeout=300)
        out.seek(0)
        _SASS[lib_path] = out.read()
        out.close()
    return _SASS[lib_path]


def sass_count(lib_path: str, kernel: str, opcode: str, also: str = "") -> str:
    """The instructions whose opcode starts with ``opcode`` in the built
    instances of ``kernel`` (whose mangled names also hold ``also``), by
    opcode (cuobjdump -sass; report only)."""
    try:
        sass = _sass(lib_path)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not measured ({e})"
    fns, cur, found = 0, False, {}
    pat = re.compile(rf"\b({re.escape(opcode)}[\w.]*)")
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = kernel in ln and also in ln
            fns += cur
        elif cur and (m := pat.search(ln)):
            found[m.group(1)] = found.get(m.group(1), 0) + 1
    return f"{sum(found.values())} {json.dumps(found)} in {fns} {kernel} instances"


def sass_loop_counts(lib_path: str, kernel: str) -> str:
    """Per built instance of ``kernel``, its hot loop in ``cuobjdump -sass``:
    of the backward branches' bodies with 8 FMULs or more, the densest in
    FMULs (the k loop, not the block loop around it), and its LDS, FMUL and
    FADD counts (shared loads a product = LDS/FMUL; report only)."""
    try:
        sass = _sass(lib_path)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not measured ({e})"
    out, fns, cur = {}, [], None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = [] if kernel in ln else None
            if cur is not None:
                fns.append((re.search(r"ILi(\d+)E", ln), cur))
        elif cur is not None:
            cur.append(ln)
    for tmpl, lines in fns:
        ins, labels, best = [], {}, None  # (address, text) of each instruction; label → address
        for ln in lines:
            if m := re.match(r"\s*(\.L_x_\d+):", ln):
                labels[m.group(1)] = len(ins)
            elif m := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*)", ln):
                ins.append((int(m.group(1), 16), m.group(2)))
        for i, (addr, text) in enumerate(ins):
            m = re.search(r"\bBRA\b\s+(?:`?\(?(\.L_x_\d+)|0x([0-9a-f]+))", text)
            if not m:
                continue
            start = labels.get(m.group(1)) if m.group(1) else next(
                (j for j, (a, _) in enumerate(ins) if a == int(m.group(2), 16)), None)
            if start is None or start > i:
                continue  # not a backward branch
            body = [t for _, t in ins[start:i + 1]]
            cnt = {op: sum(1 for t in body if re.search(rf"\b{op}\b", t)) for op in ("LDS", "FMUL", "FADD")}
            cnt["instructions"] = len(body)
            if cnt["FMUL"] >= 8 and (best is None or cnt["FMUL"] / len(body) > best["FMUL"] / best["instructions"]):
                best = cnt
        if best and best["FMUL"]:
            key = f"{kernel}<{tmpl.group(1) if tmpl else '?'}>"
            out[key] = {**best, "loads_per_product": round(best["LDS"] / best["FMUL"], 3)}
    return json.dumps(out)


PAR_WORLD = 3  # ranks of the parallel path's group: tp = 3 takes all three, the 2-rank meshes ranks 0 and 1
PAR_LABEL = "ranks time-sliced on one card, gloo through the host: parallel parity, not speed"
PAR_REPS = 3  # timed forwards a parallel scenario on rank 0
# scenario → (family, kind, mesh, options)
PAR_SCENARIOS = {
    "dp2": ("vit", "dp", 2, {}),
    "tp2": ("vit", "tp", 2, dict(fuse_qkv=True)), "tp2_unfused": ("vit", "tp", 2, dict(fuse_qkv=False)),
    "tp3": ("vit", "tp", 3, dict(fuse_qkv=True)), "tp3_unfused": ("vit", "tp", 3, dict(fuse_qkv=False)),
    "tp2_sp": ("vit", "tp", 2, dict(seq_parallel=True)),
    "pp2_m2": ("vit", "pp", 2, dict(n_micro=2)), "pp2_m4": ("vit", "pp", 2, dict(n_micro=4)),
    "swin_tp3": ("swin", "tp", 3, {}),
}
PAR_BATCHES = (64, 61)  # a full batch, then a short one (pad and trim)
FAULT_REPS = 3  # timed calls a held shape of the shape-fault phase (small shapes: launch-bound)


def _par_predicted(kind, cfg, opts, rank, n):
    """Launches one forward should make on a rank (n ranks in the mesh)."""
    from p2vit_tpu_torch import serving, serving_swin

    if kind == "dp":
        return serving.launches_per_forward(cfg)
    if kind == "pp":
        per = cfg.depth // n
        counts = {"fused_vit_layer": per * opts["n_micro"], "int8_matmul_requant": 1}
        if rank == 0:
            counts["fused_patch_embed"] = 1
        return counts
    if hasattr(cfg, "depths"):  # Swin TP: proj, the plain fc2s and the fc2 junctions run as exact partials
        c = serving_swin.launches_per_forward(cfg)
        blocks, merges = sum(cfg.depths), cfg.num_layers - 1
        c["int8_matmul_requant"] = 2 * blocks + merges + 1
        c.pop("int8_matmul_res_ln", None)
        return c
    depth = cfg.depth
    if opts.get("fuse_qkv", True):  # ViT TP: qkv-fused attention, fc1 and the head through kernels
        return {"fused_patch_embed": 1, "lis_attention_qkv_fused": depth, "int8_matmul_requant": depth + 1}
    return {"fused_patch_embed": 1, "lis_attention_fused": depth, "int8_matmul_requant": 2 * depth + 1}


# the kernels held at shard shapes: (ops module, wrapper, plain version, which calls)
PAR_HELD = (("attention_lis", "lis_attention_qkv_fused", "lis_attention_qkv_fused_plain", None),
            ("attention_lis", "lis_attention_fused", "lis_attention_fused_plain", None),
            ("matmul_int8", "int8_matmul_requant", "int8_matmul_requant_plain", "gelu"),
            ("attention_lis", "swin_lis_attention", "swin_lis_attention_plain", None),
            ("layer_fused", "fused_vit_layer", "fused_vit_layer_plain", None))


def _par_shape(a):
    return "×".join(str(d) for d in a.shape) if isinstance(a, torch.Tensor) else str(a)


def _parallel_rank(dev, path, names):
    """One rank of the parallel path: load the states, build every mesh (all
    ranks, one order), then per scenario on its mesh's ranks: the forward at
    each of ``PAR_BATCHES`` (launch counts of the first against the shard's
    prediction; every kernel call's arguments captured), ``PAR_REPS`` timed
    forwards at the full batch on rank 0 (CUDA events; the seconds in
    host-staged collectives), and on rank 0 the kernels of ``PAR_HELD`` held
    against their plain versions on the first captured call at each shape."""
    from p2vit_tpu_torch import ops, serving
    from p2vit_tpu_torch.ops import launch_counts, reset_launch_counts
    from p2vit_tpu_torch.parallel import dist as pdist
    from p2vit_tpu_torch.parallel import mesh as pmesh
    from p2vit_tpu_torch.parallel import pipeline, tensor, tensor_swin

    st = torch.load(path, map_location=dev, weights_only=False)
    rank = pdist.rank()
    meshes = {n: pmesh.make_mesh(n, 1) for n in (2,)}
    tp_meshes = {n: pmesh.make_mesh(n, n) for n in (2, 3)}
    pp_mesh = pipeline.make_pipeline_mesh(2)
    out = {}
    for name in names:
        fam, kind, n, opts = PAR_SCENARIOS[name]
        mesh = pp_mesh if kind == "pp" else meshes[n] if kind == "dp" else tp_meshes[n]
        if not mesh.member:
            continue
        cfg = st["deit_cfg"] if fam == "vit" else st["swin_cfg"]
        if kind == "dp":
            fn = pmesh.dp_serving_fn(lambda x: serving.serving_forward(st["deit"], cfg, x), mesh)
        elif kind == "pp":
            fn = pipeline.pp_serving_fn(st["deit"], cfg, mesh, **opts)
        elif fam == "vit":
            fn = tensor.tp_serving_fn(st["deit"], cfg, mesh, **opts)
        else:
            fn = tensor_swin.tp_serving_fn(st["swin"], st["swin_q"], cfg, mesh, lis=st["swin_policy"].int_softmax)
        x = st["x_swin" if fam == "swin" else "x"]
        res = {"logits": [], "counts": None, "predicted": _par_predicted(kind, cfg, opts, rank, n)}
        calls = {}
        for b in PAR_BATCHES:
            reset_launch_counts()
            got = _capture([getattr(ops, m) for m, *_ in PAR_HELD], [w for _, w, *_ in PAR_HELD],
                           lambda b=b: res["logits"].append(fn(x[:b])))
            torch.cuda.synchronize()
            if res["counts"] is None:
                res["counts"] = {k: v for k, v in launch_counts().items() if v}
            for k, v in got.items():
                calls.setdefault(k, []).extend(v)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        c0 = pdist.COLLECTIVE_S[0]
        t0 = time.perf_counter()
        start.record()
        for _ in range(PAR_REPS):
            fn(x)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res["ms"] = start.elapsed_time(end) / PAR_REPS
        res["collective_share"] = (pdist.COLLECTIVE_S[0] - c0) / wall
        if rank == 0:
            held = {}
            for mod, wname, pname, which in PAR_HELD:
                seen = set()
                for a, k in calls.get(wname, []):
                    if which == "gelu" and not k.get("gelu"):
                        continue
                    key = tuple(_par_shape(v) for v in a[:3] if not (isinstance(v, torch.Tensor) and v.dim() == 0))
                    if key in seen:
                        continue
                    seen.add(key)
                    m = getattr(ops, mod)
                    want = getattr(m, pname)(*a, **k)
                    have = getattr(m, wname)(*a, **k)
                    pairs = zip(_as_tuple(have), _as_tuple(want))
                    held.setdefault(wname, []).append((" ".join(key), sum(int((h != w).sum()) for h, w in pairs)))
            res["held"] = held
        out[name] = res
    return out


def run_parallel_path(dev, smi, states):
    """The ``parallel`` path: the ``deit`` and ``swin`` states (DeiT-S W4A8,
    LIS on; Swin-T W4) to a file, the single-process logits at each batch
    here, then ``PAR_WORLD`` ranks on this card (``run_ranks``; the kernel
    library is built already) run every scenario; each scenario's logits at
    every batch must equal the single-process ones bit for bit, every
    kernel held at a shard shape must show 0 mismatches, and every rank's
    launches must equal the shard's prediction."""
    import os
    import tempfile

    from p2vit_tpu_torch import serving, serving_swin
    from p2vit_tpu_torch.parallel import dist as pdist

    d, sw = states["deit"], states["swin"]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((max(PAR_BATCHES), 3, d["cfg"].img_size, d["cfg"].img_size), generator=gen).to(dev)
    xs = torch.randn((max(PAR_BATCHES), 3, sw["cfg"].img_size, sw["cfg"].img_size), generator=gen).to(dev)
    ref = {}
    for b in PAR_BATCHES:
        ref["vit", b] = serving.serving_forward(d["s"], d["cfg"], x[:b]).cpu()
        ref["vit_layer", b] = serving.serving_forward(d["s"], d["cfg"], x[:b], fuse_layer=True).cpu()
        ref["swin", b] = serving_swin.serving_forward(sw["s"], sw["qstate"], sw["cfg"], sw["policy"], xs[:b]).cpu()
    for b in PAR_BATCHES:
        if not torch.equal(ref["vit", b], ref["vit_layer", b]):
            _fail(f"parallel: the fused layer's logits at batch {b} differ from the default path's")
    names = list(PAR_SCENARIOS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "states.pt")
        torch.save({"deit": d["s"], "deit_cfg": d["cfg"], "swin": sw["s"], "swin_q": sw["qstate"],
                    "swin_cfg": sw["cfg"], "swin_policy": sw["policy"], "x": x, "x_swin": xs}, path)
        t0 = time.time()
        outs = pdist.run_ranks(_parallel_rank, PAR_WORLD, path, names, device=dev, timeout_s=600)
        print(f"parallel: {PAR_WORLD} ranks on {dev} ran {len(names)} scenarios in {time.time() - t0:.1f} s "
              f"({PAR_LABEL})", flush=True)
    bad = []
    for name in names:
        fam, kind, n, opts = PAR_SCENARIOS[name]
        for r, o in enumerate(outs):
            if name not in o:
                continue
            res = o[name]
            for b, got in zip(PAR_BATCHES, res["logits"]):
                n_diff = int((got != ref[fam, b]).sum()) if got.shape == ref[fam, b].shape else got.numel()
                if n_diff:
                    bad.append(f"{name} rank {r} batch {b}: {n_diff} logits differ from one process")
            if res["counts"] != res["predicted"]:
                bad.append(f"{name} rank {r}: launches {res['counts']} against the shard's {res['predicted']}")
            print(f"parallel {name} rank {r}: launches at batch {PAR_BATCHES[0]} {res['counts']} "
                  f"(shard predicts {res['predicted']}); ms per forward at batch {PAR_BATCHES[0]} "
                  f"{res['ms']:.3f}, host-staged collectives {100 * res['collective_share']:.1f} % of it "
                  f"({PAR_LABEL}; {smi})", flush=True)
        for wname, rows in outs[0][name].get("held", {}).items():
            for shape, mism in rows:
                print(f"parallel {name}: {wname} at shard shape {shape}: {mism} mismatches against its plain "
                      f"version", flush=True)
                if mism:
                    bad.append(f"{name}: {wname} at {shape}: {mism} mismatches")
        print(f"parallel {name}: logits at batches {PAR_BATCHES} against one process's serving_forward: "
              f"{'equal' if not any(m.startswith(name + ' ') for m in bad) else 'DIFFER'}", flush=True)
    held = {w for o in outs[:1] for r in o.values() for w in r.get("held", {})}
    for _, wname, *_ in PAR_HELD:
        if wname not in held:
            bad.append(f"{wname} was held at no shard shape")
    bad += run_mesh_surfaces(dev, smi)
    if bad:
        _fail("parallel: " + "; ".join(bad))


def run_mesh_surfaces(dev, smi) -> list:
    """The three mesh surfaces (``dryrun.ENVELOPES``) on ``PAR_WORLD``
    ranks of this card at the dry run's tiny ViT, a batch of 6 (the 3 × 1
    data mesh takes 2 images a rank, the 1 × 2 TP mesh all 6), against one
    process's; returns the failures."""
    from p2vit_tpu_torch.parallel import dist as pdist
    from p2vit_tpu_torch.parallel import dryrun

    t0 = time.time()
    st = dryrun.tiny_states(dev, batch=2 * PAR_WORLD)
    names = dryrun.ENVELOPES
    outs = pdist.run_ranks(dryrun.run_scenarios, PAR_WORLD, pdist.map_tensors(st, lambda t: t.cpu()), names,
                           device=dev, timeout_s=300)
    lines, n_bad = dryrun.report(outs, dryrun.references(st, names), st, names)
    for line in lines:
        print(f"parallel mesh surface {line} ({PAR_WORLD} ranks on {dev}, {PAR_LABEL}; {smi})", flush=True)
    print(f"parallel: the mesh surfaces in {time.time() - t0:.1f} s", flush=True)
    return [f"mesh surfaces: {n_bad} elements differ or lie outside their envelopes"] if n_bad else []


def run_shape_faults(dev, smi) -> None:
    """The shape-fault phase: ``tools/shape_faults.check`` at every held
    shape (the kernel against its plain version, one counted launch a call,
    device time in the kernel's symbol; any fault fails), one line per shape
    with the µs per call, the device µs, the kernel's and the bound."""
    from p2vit_tpu_torch.tools import shape_faults as sf

    bad = []
    for r in sf.check(dev, FAULT_REPS):
        print(f"shape fault {r['fault']}: {r['case']}: {r['mismatches']} mismatches against the plain version, "
              f"{r['launches']} launch; {r['us']:.1f} µs a call (events), device {r['device_us']:.1f} µs, "
              f"{r['kernel']} {r['kernel_us']:.1f} µs, bound {r['bound_us']:.2f} µs ({smi})", flush=True)
        if r["faults"]:
            bad.append(f"{r['case']}: {', '.join(r['faults'])}")
    if bad:
        _fail("shape faults: " + "; ".join(bad))


def vit_paths(name, key, cfg, bits, params, qstate, policy, s, lis, variants, mean=MEAN, std=STD) -> list:
    """The ``Path`` of each ``DEIT_FLAGS`` key in ``variants`` on one ViT
    serving state (uint8 ingest attached when LIS is off): key ``key`` +
    variant (+ "_lisoff"); the bf16 forward on the default LIS-on path; the
    fused layer held bitwise against the default."""
    from p2vit_tpu_torch import serving
    from p2vit_tpu_torch.models import vit

    suffix, ksuffix = ("", "") if lis else (" LIS-off", "_lisoff")
    idx = vit.bits_to_idx(bits)
    base = lambda x, k: serving.serving_forward(s, cfg, x, use_kernels=k, lis=lis)  # noqa: E731
    out = []
    for var in variants:
        label, flags = DEIT_FLAGS[var]
        per_forward = serving.launches_per_forward(cfg, **flags)
        layer = var == "_layer"
        out.append(Path(
            name + label + suffix, key + var + ksuffix, tuple(per_forward), per_forward,
            lambda x, k, flags=flags: serving.serving_forward(s, cfg, x, use_kernels=k, lis=lis, **flags),
            lambda x: vit.quant_forward(params, qstate, cfg, policy, x, idx),
            None if (var or not lis) else lambda x, p=_cast_tree(params, torch.bfloat16): vit.fp_forward(
                p, cfg, x.to(torch.bfloat16)),
            cfg.num_classes, cfg.img_size, u8_state=None if lis else s, split_check=var == "_staged",
            base=base if layer else None, base_name=name + suffix if layer else None,
            base_key=key + ksuffix if layer else None, vs_base="bitwise" if layer else None,
            mean=mean, std=std))
    return out


def swin_paths(name, key, cfg, params, qstate, policy, s, keys, mean=MEAN, std=STD) -> list:
    """The ``Path`` of each ``SWIN_FLAGS`` key in ``keys`` (one LIS setting)
    on one Swin serving state: key ``key`` + the flag key past "swin"; the
    bf16 forward on the default path; flag paths against the default of the
    same state (``SWIN_FLAGS``' check)."""
    from p2vit_tpu_torch import serving_swin
    from p2vit_tpu_torch.models import swin

    def fwd(x, k, **flags):
        return serving_swin.serving_forward(s, qstate, cfg, policy, x, use_kernels=k, **flags)

    out = []
    for flag_key in keys:
        lis, flags, vs_base = SWIN_FLAGS[flag_key]
        off = "" if lis else " LIS-off"
        per_forward = serving_swin.launches_per_forward(cfg, **flags)
        out.append(Path(
            name + SWIN_NAMES[flag_key], key + flag_key[4:], tuple(per_forward), per_forward,
            lambda x, k, flags=flags: fwd(x, k, **flags),
            lambda x: swin.quant_forward(params, qstate, cfg, policy, x, 4),
            None if flag_key != "swin" else lambda x, p=_cast_tree(params, torch.bfloat16): swin.fp_forward(
                p, cfg, x.to(torch.bfloat16)),
            cfg.num_classes, cfg.img_size, u8_state=None if lis else s,
            base=None if vs_base is None else fwd, base_name=None if vs_base is None else name + off,
            base_key=None if vs_base is None else key + ("" if lis else "_lisoff"), vs_base=vs_base,
            s_bn=qstate["patch_qact_bn"]["scale"], mean=mean, std=std))
    return out


def run_zoo(members, setup, img, ops, counts_api, reps) -> dict:
    """The zoo members' paths (``ZOO``), each member at full width and
    depth: seeded init, calibrated on ``ZOO_CALIB`` seeded images, W4A8
    ``[4]*num_matmuls`` (ViT) or ``convert(4)`` (Swin); each path through
    ``run_path``'s zoo form (phases 1-4 at ``ZOO_BATCHES``, the profiler
    window at ``ZOO_WINDOW``); a ViT member without a fused-layer path held
    to ``fuse_layer=True`` raising ValueError naming ``fuse_layer=False``,
    with nothing launched. Returns {path name: per-kernel results}."""
    from p2vit_tpu_torch import serving, serving_swin
    from p2vit_tpu_torch.models import PREPROCESS, SWIN_ZOO, VIT_ZOO, swin, vit

    reset_launch_counts, launch_counts = counts_api
    per_model = {}
    for member in members:
        zoo_name, disp, family, on_paths, off_paths = ZOO[member]
        mean, std = PREPROCESS[family]["mean"], PREPROCESS[family]["std"]
        for lis, keys in ((True, on_paths), (False, off_paths)):
            if not keys:
                continue
            label = disp + ("" if lis else " LIS-off")
            if family != "swin":
                cfg = VIT_ZOO[zoo_name]
                bits = [4] * cfg.num_matmuls
                params, qstate, policy, s = setup(
                    label, vit, cfg, lis, lambda p, q, c, pol, bits=bits: serving.convert(p, q, c, pol, bits),
                    ZOO_CALIB, mean, std)
                if not lis:
                    serving.attach_u8_ingest(s, mean, std)
                paths = vit_paths(disp, member, cfg, bits, params, qstate, policy, s, lis, keys, mean, std)
                if lis and "_layer" not in on_paths:
                    reset_launch_counts()
                    try:
                        serving.serving_forward(s, cfg, img(1, cfg.img_size), fuse_layer=True)
                        _fail(f"{disp}: serving_forward(fuse_layer=True) ran; the fused layer does not fit it")
                    except ValueError as e:
                        launched = {k: v for k, v in launch_counts().items() if v}
                        print(f"{disp} fuse_layer=True raises ValueError: {e}; launches {json.dumps(launched)}",
                              flush=True)
                        if "fuse_layer=False" not in str(e) or launched:
                            _fail(f"{disp}: fuse_layer=True raised without naming fuse_layer=False, or "
                                  f"launched {launched}")
            else:
                cfg = SWIN_ZOO[zoo_name]
                params, qstate, policy, s = setup(
                    label, swin, cfg, lis, lambda p, q, c, pol: serving_swin.convert(p, q, c, pol, 4),
                    ZOO_CALIB, mean, std)
                if not lis:
                    serving_swin.attach_u8_ingest(s, mean, std)
                paths = swin_paths(disp, member, cfg, params, qstate, policy, s, keys, mean, std)
            for path in paths:
                t0 = time.time()
                per_model[path.name], _ = run_path(path, ZOO_BATCHES, reps, img, ops, counts_api, window=ZOO_WINDOW)
                print(f"{path.name}: the zoo path in {time.time() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    return per_model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default=",".join(PATHS),
                    help=f"paths to drive, any of {', '.join(PATHS)} (default all)")
    ap.add_argument("--depth", type=int, default=12, help="DeiT-S encoder depth (12 in the model)")
    ap.add_argument("--batches", default="1,8,64", help="request batch sizes")
    ap.add_argument("--calib", type=int, default=32, help="calibration images")
    ap.add_argument("--reps", type=int, default=20, help="timed repetitions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    batches = [int(b) for b in args.batches.split(",")]
    models = args.models.split(",")
    if set(models) - set(PATHS):
        _fail(f"unknown paths {sorted(set(models) - set(PATHS))}; choose from {PATHS}")

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; this script needs one CUDA GPU")
    from p2vit_tpu_torch import ops, serving, serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO, swin, vit
    from p2vit_tpu_torch.ops import KERNELS, _lib, launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.time()
    _, log = _lib.library()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: {time.time() - t0:.1f} s ({len(regs)} ptxas lines)")
    for ln in regs:
        print(f"  ptxas {ln}")
    so = _lib.library()[0]._name
    start_sass(so)  # read after the paths: cuobjdump runs beside them
    bad = ops.intln.ln_chain_check(dev)
    print(f"int-LN chain rewrites (2^N bits, unit-ratio fold) against ln_elem over all 2^32 floats: "
          f"mismatches {bad}", flush=True)
    if any(bad):
        _fail(f"the int-LN kernels' chain rewrites disagree with ln_elem: {bad}")

    t0 = time.time()
    run_shape_faults(dev, smi)
    print(f"shape faults: the phase in {time.time() - t0:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(args.seed + 1)

    def img(b, size, u8=False):
        """Seeded request images: float32 normal, or uint8 uniform."""
        if u8:
            return torch.randint(0, 256, (b, 3, size, size), generator=gen, dtype=torch.uint8).to(dev)
        return torch.randn((b, 3, size, size), generator=gen).to(dev)

    def setup(name, model, cfg, lis, convert, n_calib=args.calib, mean=MEAN, std=STD):
        """Seeded init → calibrate on one batch of ``n_calib`` images (uint8
        images normalized on the host by ``mean``/``std`` when LIS is off,
        float32 otherwise) → convert; returns (params, qstate, policy,
        serving state)."""
        t0 = time.time()
        policy = make_policy(lis=lis)
        params = model.init_params(args.seed, cfg, device=dev)
        x = img(n_calib, cfg.img_size, not lis)
        calib = model.calibrate(params, cfg, policy, host_normalize(x, mean, std) if not lis else x)
        s = convert(params, calib.qstate, cfg, policy)
        torch.cuda.synchronize()
        print(f"{name} setup: calibrate({n_calib} images) + convert {time.time() - t0:.1f} s")
        return params, calib.qstate, policy, s

    if "swin" in models:
        t0 = time.time()
        tiny_swin_checks(dev, ops)
        print(f"TINY Swin head_dim checks in {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        window12_checks(dev, ops)
        print(f"Swin window-12 checks in {time.time() - t0:.1f} s", flush=True)
    if "swin_stem" in models:
        t0 = time.time()
        wide_stem_checks(dev, ops)
        print(f"wide stem checks in {time.time() - t0:.1f} s", flush=True)

    paths = []
    states = {}  # the LIS-on DeiT-S and Swin-T states, for the weight-only and w4pack paths
    deit = [m for m in models if (m.startswith("deit") and m not in ZOO) or m in ("w4pack", "parallel")]
    if deit:
        cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], depth=args.depth)
        bits = [4] * cfg.num_matmuls
        idx = vit.bits_to_idx(bits)
        vit_convert = lambda p, q, c, pol: serving.convert(p, q, c, pol, bits)  # noqa: E731
        for lis in (True, False):
            if not any(m.endswith("lisoff") != lis for m in deit):
                continue
            suffix = "" if lis else " LIS-off"
            params, qstate, policy, s = setup("DeiT-S" + suffix, vit, cfg, lis, vit_convert)
            if not lis:
                serving.attach_u8_ingest(s, MEAN, STD)
            else:
                states["deit"] = dict(params=params, qstate=qstate, policy=policy, s=s, cfg=cfg, bits=bits,
                                      idx=idx, img=lambda b, cfg=cfg: img(b, cfg.img_size))
            variants = [v for v in DEIT_FLAGS if "deit" + v + ("" if lis else "_lisoff") in models]
            paths += vit_paths("DeiT-S", "deit", cfg, bits, params, qstate, policy, s, lis, variants)
    for lis in (True, False):
        keys = [m for m in SWIN_FLAGS if m in models and SWIN_FLAGS[m][0] == lis]
        if not keys and not (lis and ("swin_wonly" in models or "parallel" in models)):
            continue
        cfg = SWIN_ZOO["swin_tiny_patch4_window7_224"]
        params, qstate, policy, s = setup("Swin-T" + ("" if lis else " LIS-off"), swin, cfg, lis,
                                          lambda p, q, c, pol: serving_swin.convert(p, q, c, pol, 4))
        if not lis:
            serving_swin.attach_u8_ingest(s, MEAN, STD)
        else:
            states["swin"] = dict(params=params, qstate=qstate, policy=policy, s=s, cfg=cfg)
        paths += swin_paths("Swin-T", "swin", cfg, params, qstate, policy, s, keys)

    per_model, summary = {}, {}
    for path in paths:
        t0 = time.time()
        per_model[path.name], summary[path.name] = run_path(
            path, batches, args.reps, img, ops, (reset_launch_counts, launch_counts))
        print(f"{path.name}: phases 1-5 in {time.time() - t0:.1f} s", flush=True)
    counts_api = (reset_launch_counts, launch_counts)
    members = [m for m in ZOO if m in models]
    if members:
        t0 = time.time()
        per_model.update(run_zoo(members, setup, img, ops, counts_api, args.reps))
        print(f"zoo: {len(members)} members in {time.time() - t0:.1f} s", flush=True)
    if "deit_wonly" in models:
        t0, st = time.time(), states["deit"]
        pw = serving.weight_only_params(st["params"], st["qstate"], st["cfg"], st["policy"], st["bits"])
        depth = st["cfg"].depth
        run_wonly(
            "DeiT-S weight-only", vit, st["cfg"], st["params"], pw, list(_wonly_pairs_vit(pw, st["s"])),
            lambda x: serving.serving_forward(st["s"], st["cfg"], x),
            lambda x: vit.quant_forward(st["params"], st["qstate"], st["cfg"], st["policy"], x, st["idx"]),
            batches, args.reps, img, counts_api, wstream=(st["s"], sorted({0, depth - 1}), ops.matmul_wstream))
        print(f"DeiT-S weight-only: phases 1-5 in {time.time() - t0:.1f} s", flush=True)
    if "swin_wonly" in models:
        t0, st = time.time(), states["swin"]
        pw = serving_swin.weight_only_params(st["params"], st["qstate"], st["cfg"], st["policy"], 4)
        run_wonly("Swin-T weight-only", swin, st["cfg"], st["params"], pw, list(_wonly_pairs_swin(pw, st["s"])),
                  lambda x: serving_swin.serving_forward(st["s"], st["qstate"], st["cfg"], st["policy"], x),
                  lambda x: swin.quant_forward(st["params"], st["qstate"], st["cfg"], st["policy"], x, 4),
                  batches, args.reps, img, counts_api)
        print(f"Swin-T weight-only: phases 1-5 in {time.time() - t0:.1f} s", flush=True)
    for key, run in (("w4pack", lambda: run_w4pack(batches, args.reps, args.depth, dev, states.get("deit"),
                                                   ops, counts_api)),
                     ("wstream", lambda: run_wstream(batches, args.reps, args.depth, dev, ops, counts_api))):
        if key in models:
            t0 = time.time()
            per_model[key] = run()
            print(f"{key}: phases 1-5 in {time.time() - t0:.1f} s", flush=True)

    if "cli" in models:
        t0 = time.time()
        run_cli_path(dev, smi, args.seed, counts_api)
        print(f"cli: the path in {time.time() - t0:.1f} s", flush=True)
    if "datafree" in models:
        t0 = time.time()
        run_datafree_path(dev, smi, args.seed, counts_api)
        print(f"datafree: the path in {time.time() - t0:.1f} s", flush=True)
    if "plan" in models:
        t0 = time.time()
        run_plan_path(dev, smi, list(PLAN_BATCHES), PLAN_ITERS)
        print(f"plan: the path in {time.time() - t0:.1f} s", flush=True)
    if "parallel" in models:
        t0 = time.time()
        run_parallel_path(dev, smi, states)
        print(f"parallel: the path in {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    print(f"sass: DMMA instructions {sass_count(so, 'wstream_matmul_kernel', 'DMMA')}", flush=True)
    print(f"sass: IMMA instructions {sass_count(so, 'lis_attention_qkv_kernel', 'IMMA')}", flush=True)
    print(f"sass: IMMA instructions {sass_count(so, 'swin_attention_kernel', 'IMMA')}", flush=True)
    print(f"sass: the stem's inner loop (LDS per FMUL+FADD pair) {sass_loop_counts(so, 'swin_stem_kernel')}",
          flush=True)
    print(f"sass: IMMA instructions {sass_count(so, 'attention_rows_kernel', 'IMMA')}", flush=True)
    print(f"sass: IMMA instructions {sass_count(so, 'fused_vit_layer_kernel', 'IMMA')}", flush=True)
    for kern in ("wg14requant_kernel", "wg13res_ln_kernel", "wg12embed_kernel", "fused_vit_layer_kernel"):
        for op in ("IGMMA", "UTMALDG"):
            print(f"sass: {op} instructions {sass_count(so, kern, op)}", flush=True)
    for op in ("IGMMA", "UTMALDG"):  # the int4-store instances: PACKED, the last template argument, true
        print(f"sass: {op} instructions {sass_count(so, 'wg14requant_kernel', op, also='Lb1EEEv')} "
              f"(int4_matmul_requant)", flush=True)
    print(f"sass counts in {time.time() - t0:.1f} s (one cuobjdump, started after the build)", flush=True)
    print_comparisons(summary, max(batches))
    print_flag_comparisons(paths, summary, max(batches))
    t0 = time.time()
    print_layer_comparisons(paths, summary, batches, img, args.reps)
    print(f"fused-layer comparisons in {time.time() - t0:.1f} s", flush=True)

    results = []
    for k in KERNELS:
        name = k.__name__
        runs = {m: r[name] for m, r in per_model.items() if name in r}
        if not runs and set(models) == set(PATHS):
            _fail(f"kernel {name} was held on no path")
        if not runs:
            continue
        _, _, src, rep = SOURCES[name]
        timed = {m: r for m, r in runs.items() if "batch" not in r} or runs  # the zoo's (batch 8) where alone
        results.append({
            "name": name, "route": "cuda", "source": f"p2vit_tpu_torch/csrc/{src}", "replaces": rep,
            "redesigned": REDESIGNED.get(name),
            "launches": sum(r["launches"] for r in runs.values()),
            "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
            "ms": round(sum(r["ms"] for r in timed.values()), 6),
            "plain_ms": round(sum(r["plain_ms"] for r in timed.values()), 6),
            "bound_ms": round(sum(r["bound_ms"] for r in timed.values()), 6),
            "bound_by": max(("bytes", "operations"),
                            key=lambda b: sum(r["bound_ms"] for r in timed.values() if r["bound_by"] == b)),
            "library_ms": (None if all(r.get("library_ms") is None for r in timed.values())
                           else round(sum(r.get("library_ms") or 0.0 for r in timed.values()), 6)),
            "per_model": {m: {kk: (round(v, 6) if isinstance(v, float) else v) for kk, v in r.items()}
                          for m, r in runs.items()},
        })
    print(f"(kernel ms / plain_ms / bound_ms: per forward at batch {max(batches)}, summed over the "
          f"DeiT-S and Swin-T paths that run the kernel, the zoo paths' per_model entries (and the sums where "
          f"only they ran) at batch {max(ZOO_BATCHES)}; launches summed over every path; lis_attention timed "
          f"at lis_attention_fused's calls; the weight-store "
          f"kernels per depth-{args.depth} chain at M = 197·{max(batches)}, wstream_matmul summed over its "
          f"four stores, its library_ms the bf16 torch.matmul over the same codes; library_ms null: no "
          f"single PyTorch call computes these quantized functions; card {smi})")
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
