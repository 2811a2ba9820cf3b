"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no try/except around them):

1. Environment: torch/CUDA versions, the card's name and power limit;
   build the CUDA C++ kernels from ``said_tpu_torch/csrc`` and compile the
   Triton kernels (the GroupNorm split), and build the native QP solver
   (``said_tpu_torch/optimize/csrc``, ``g++``), with their build times.
2. Every kernel of the main paths against its plain PyTorch twin on the
   card, at the main paths' shapes and at ragged ones, in float32 and
   bfloat16: max |kernel − plain| ≤ 1e-4 · max|plain| (f32) or
   2e-2 · max|plain| (bf16), in the working type; median CUDA-event times
   of kernel, twin and, where one PyTorch call computes the same function
   (``F.layer_norm``, ``F.group_norm`` without SiLU,
   ``scaled_dot_product_attention``), that call, each two ways: on the
   card alone (calls captured in a CUDA graph, replayed between CUDA
   events) and with the host's enqueue (CUDA events around a call on an
   idle card, taken in turns; launch overhead at small shapes);
   kernel/library is printed from the first; and each case's bound, the
   least time the card could take (bytes over 3.35 TB/s; the FLOP of
   products over the tensor cores' peak, f32 as 3xTF32; elementwise FLOP
   over the f32 FMA peak; exp2 over the special-function rate; the
   largest binds).
   LayerNorm runs at the UNet's 10-s, 60-s and 6-min shapes, the
   encoder's at 10 s, 50 s and 5 min (feature projection and layers), a
   "layer" feature extractor's conv_0 of a 10-s clip (with ``F.layer_norm``
   in bf16 too), and ragged; each case prints its plan (lanes a row × 16-byte vectors a
   lane, rows a block, blocks). The strided conv runs at the six 10-s
   shapes of conv_1 … conv_6, the 60-s conv_1 and two ragged ones, each
   with its route, beside the unfused ``F.gelu(F.conv1d(...))`` (cuDNN,
   TF32 off in f32; ``unfused_ms``, a yardstick, never ``library_ms``).
   GroupNorm runs at the UNet's 10-s, 30-s, 60-s, 4096-frame and 6-min
   shapes and the encoder's conv_0 at a 4-s clip and a 32k-sample
   bucket; each case prints its plan and route (one launch of
   ``csrc/group_norm.cu`` with its groups a block, cluster size and CTAs,
   or the Triton split with its chunks), and at the UNet's batch-2 shapes
   and the 4-s conv_0 every one-launch plan the kernel takes and the
   split are forced and timed too (each as close to the twin, and
   bit-identical over two calls): the data of the plan and of the
   threshold between the two routes.
   Flash attention runs at the UNet's and the
   encoder's widths at 60 s and 6 min (3600 and 21600 frames), ragged at
   2100, and with lengths [384, 200, 0]. The masked GroupNorm (length-
   bucketed mode) runs at the UNet's eval-batch (every one-launch plan
   forced too) and 60-s bucketed shapes,
   at the encoder's conv_0 shapes of the eval batch and of a 60-s clip,
   and ragged; no single PyTorch call computes it, so it has no library
   time. GEGLU runs at the UNet's 10-s, 60-s and 6-min shapes, the eval
   call's and ragged ones; it has no library call either, and is timed
   beside its unfused composition (``F.linear``, the gate, ``F.linear``
   in the working dtype: a yardstick of three calls, ``unfused_ms``, never
   ``library_ms``) and, at the main path's four shapes, under every plan
   the kernel takes (each as close to the twin, and bit-identical over
   two calls). Flash attention, GEGLU and the strided conv carry a bf16
   record beside the f32 one in the JSON line.
2b. Each kernel's autograd wrapper (the router where an input needs a
   gradient: the kernel forward, a PyTorch backward) on the card against
   its plain twin differentiated by autograd: GroupNorm plain and masked
   (+SiLU), LayerNorm at the training path's shapes, flash attention at
   2400 keys (the dense-recompute backward, with and without lengths) and
   4200 (the blockwise one), GEGLU and the strided conv; forward and every
   input gradient within the bounds of phase 2, relative to max |plain|.
3. One request through the real CLI ``main(argv)``: a synthetic 10-s WAV
   (600 frames), 1000 DDIM steps, CFG 2.0, float32, random weights from
   seed 0. The CSV must hold 600 rows under the 32 ARKit names, finite and
   in [0, 1]; the launch counters, zeroed just before, must read exactly
   GroupNorm 15·1000+1, LayerNorm 12·1000+26, GEGLU 4·1000, conv 6, and
   flash attention 0 (600 frames stay on the dense path).
4. Card against CPU: the same seeded weights and injected latents on a
   4-s clip, 20 steps, through ``SAIDPipeline`` on cuda (kernels) and on
   cpu (plain twins): coefficient MAE ≤ 1e-4 and max ≤ 1e-3, with a
   denoiser output std > 1e-3 so the comparison cannot pass vacuously.
5. bfloat16 against float32 on the card, on phase 4's weights, clip and
   latents: the audio embedding and one CFG-folded denoiser call (t=999)
   computed in bf16 must lie within BF16_BOUND of the f32 results,
   relative to max |f32|. This catches a bf16 fault outside the kernels
   (casts, attention, the null embedding, the K/V caches), which the
   per-kernel checks cannot see.
6. A bfloat16 request (4-s clip, 100 steps): finite and in [0, 1]; its
   MAE against the float32 card run of the same request is printed. (The
   100-step chain amplifies rounding, so this number is not a check.)
7. A 60-s request through the CLI (3600 frames, 1000 DDIM steps, CFG 2.0,
   float32): 3600 rows in [0, 1]; counters as in phase 3 and flash
   attention 4·1000 + 12 (4 UNet self-attentions a step, 12 encoder
   layers once).
8. A 6-min request through the CLI (21600 frames, ``--solver dpmpp_2m
   --num_steps 25``, float32): 21600 finite rows in [0, 1]; counters
   GroupNorm 15·25+1, LayerNorm 12·25+26, GEGLU 4·25, conv 6, flash
   attention 4·25 + 12.
9. Card against CPU on a 40-s clip (2400 frames, past the dense limit):
   the audio embedding and one CFG-folded denoiser call at t = 999, on
   the card (flash kernel) and on the CPU (its plain version), same
   weights and latents: max |card − CPU| ≤ 1e-4 · max |CPU| for each.
10. The eval-generation CLI ``said_tpu_torch.cli.test_inference.main`` on a
    synthetic test split: 2 persons × 2 sentences of 2.6, 3.4, 4.3 and
    5.1 s (156, 204, 258 and 306 frames; bucket 256, so 256 or 512
    frames). First ``--num_repeats 8 --batch_size 8``, 1000 DDIM steps,
    CFG 2.0, f32: 32 CSVs of the clips' row counts in [0, 1], and launch
    counts over the 4 calls of exactly 4 × (masked GroupNorm 15·1000+1,
    LayerNorm 12·1000+26, GEGLU 4·1000, conv 6, GroupNorm 0, flash 0).
    Then ``--mixed_batching --batch_size 12 --num_steps 100``: 3 batches,
    the first holding two clips, 32 CSVs again.
11. Mixed lengths on the card: 3 rows of 2.0, 3.3 and 4.3 s in one
    bucketed batch (bucket 256), injected latents, 20 DDIM steps. Each
    row's real frames against its own unbucketed run on the card, and the
    batch on the card against the same batch on the CPU: coefficient MAE
    ≤ 1e-4 and max ≤ 1e-3, with a denoiser output std > 1e-3.
12. A bucketed 60-s request through the CLI (3600 frames in a 3840-frame
    bucket, ``--solver dpmpp_2m --num_steps 25 --length_bucket 256``):
    3600 rows in [0, 1]; every flash launch (4·25 + 12) takes lengths;
    masked GroupNorm 15·25+1, GroupNorm 0. Then, with injected latents,
    the audio embedding and one CFG-folded denoiser call at t = 999,
    bucketed against unbucketed on the card, on the real frames: within
    1e-4 of max |unbucketed|.

13. Training, card against CPU, at full width (f32, deterministic,
    injected timesteps and noise): ``said_loss`` and its gradients for
    batch 2 at a 600-frame window bucketed with 597 real frames, on the
    card (kernels) and on the CPU (plain twins): the loss within 1e-5
    relative, each trainable tensor's gradient within 1e-3 relative L2 and
    the global norm within 1e-4. The L1 losses' gradient is a sign: where
    card and CPU predictions straddle the answer (a near-tie) the loss's
    gradient differs by 2/N there, so the script counts those elements;
    with none the gradients themselves are held to the bounds, with some
    the card's backward is held to them on the CPU's gradient at the
    prediction, and every flip must be a near-tie (|residual| ≤ 1e-4).
    The card's launch counters show the path's kernels ran.
14. The same at batch 1 and a 2400-frame window (the flash kernel forward,
    the dense-recompute backward; 16 flash launches); then a 4200-frame
    window on the card alone, whose blockwise backward (1024-key blocks)
    must match the dense recompute within 1e-4 relative L2 per tensor.
15. The training CLI ``said_tpu_torch.cli.train`` at full width on a
    synthetic tree (2 train persons × 8 sentences, 1 val person × 2, 5 s
    each; batch 8, default windows and buckets): 4 f32 epochs (checkpoints
    at 2 and 4, validation at 4), ``--resume`` from epoch 2 for one epoch,
    3 bf16 epochs. Finite losses, no skipped step, the metrics lines, the
    checkpoints and ``.pth`` files; ``4.pth`` through the inference CLI
    (strict load) gives a valid CSV; exact launch counts where the path
    fixes them (LayerNorm varies with layerdrop); the median train step
    (host, synchronised) in f32 and bf16 and the launches a step, also as
    a ``{"training": ...}`` JSON line.

16. Streaming through the CLI: phase 8's 6-min WAV with
    ``--streaming_window 3600 --streaming_overlap 360 --solver dpmpp_2m
    --num_steps 25``, f32: 7 windows (starts 0, 3240, …, 16200, 18000),
    21600 finite rows in [0, 1], launch counts exactly 7 × phase 8's (each
    window is one 3600-frame pipeline call; the editing path launches
    nothing more); its wall time beside phase 8's and beside the whole
    clip requested again right after it (warm); then the pipeline alone,
    whole clip and streaming in turns: host ms, and the card's busy ms,
    idle share and time by kernel family under ``torch.profiler``.
17. Streaming, card against CPU: a 20-s clip in 600-frame windows with a
    120-frame overlap (windows at 0, 480, 600), 10 DDIM steps, CFG 2.0,
    injected per-window noise: coefficient MAE ≤ 1e-4 and max ≤ 1e-3 with
    a denoiser output std > 1e-3; on the card each later window's raw
    result equals its init on the pinned rows bit for bit.
18. A "layer" feature extractor (``feat_extract_norm="layer"``,
    ``conv_bias``, base widths, 2 layers), card against CPU on a 4-s
    clip: the embedding within 1e-4 of max |CPU|; exactly 13 LayerNorm
    launches and no other kernel's. (Phase 2 holds K7 at its conv_0 shape,
    (1, 31999, 512), f32 and bf16, beside ``F.layer_norm``.)
19. One BCVAE train step, card against CPU: batch 32 of 120×32 windows,
    injected ε, f32 with TF32 off: the loss within 1e-5 relative, each
    gradient within 1e-4 relative L2 (the BatchNorm-cancelled biases',
    exactly 0, at most 1e-6 of the global norm), the running statistics
    within 1e-5.
20. ``train_vae`` on a synthetic coefficient tree (2 train persons × 8
    sentences, 1 val person; 3 epochs, validation every epoch, a
    checkpoint at 3): finite metrics lines and the checkpoint; its EMA
    weights as a ``.pth`` through ``inference_vae`` (a (120, 32) CSV in
    [0, 1]) and ``test_evaluate`` on a synthetic split (2 test persons × 4
    sentences × 4 repeats of 300 frames, generated = real + noise): FD,
    multimodality and WInD finite and ≥ 0, the real set's FD against
    itself ≤ 1e-6 · trace(Σ); each CLI's wall time, and the encoding and
    one mixture fit apart, also as an ``{"evaluation": ...}`` JSON line.

21. The asset pipeline at BlendVOCA's sizes (host numpy, the QP's ADMM on
    the card): 2 persons' synthetic 5023-vertex templates (FLAME's count,
    grid faces) and a deltas pickle through ``preprocess_blendvoca`` (the
    port's ``FLAME_head_idx.txt``: 4580 head vertices), then
    ``optimize_blendshape_coeffs`` over 1 sentence a person of 120 binary
    PLY frames (head = neutral + deltas times known smooth weights +
    noise; delta 0.1): native solver, CSVs within 5e-3 of the known
    weights. Then ``solve_sequence_qp`` at N=32 and 13740 coordinates, T
    = 240 and 3600, with the box and smoothness active: native, the
    float32 ADMM on the card and on the CPU; the card within 1e-4 of both,
    the box within 1e-6, |Δw| ≤ δ + 1e-5; wall times, iterations, and the
    ADMM's launches and device µs an iteration (``torch.profiler``, 48
    iterations less 16), equal at both T. (``g++`` builds the QP library in
    phase 1; a failed build fails the run.)
22. WAV → CSV → video: the inference CLI on a 1-s clip (``--solver
    dpmpp_2m --num_steps 25``, exact launch counts); ``render`` at
    800×800 with the WAV, ``--show_difference`` against a perturbed CSV,
    ``--save_images``: one ``00dc`` chunk a CSV row, each an SOI…EOI JPEG
    whose SOF0 says 800×800, an ``idx1`` entry a chunk, the PCM equal to
    the clipped int16 WAV, a PNG a frame; rasterize and encode ms a frame;
    ``test_render`` over a two-file tree (5 frames each).
23. An HF wav2vec2 snapshot as ``--init_weights``: a base-width
    ``model.safetensors`` written by the script's own writer (``wav2vec2.``
    prefix, ``lm_head.*``, ``masked_spec_embed``): after
    ``load_said_weights`` every audio-encoder tensor on the card is
    bit-equal to the snapshot's; two train-CLI steps from it (phase 15's
    tree) end with a finite loss and the frozen encoder still bit-equal.

24. Data-parallel training. (a) ``torch.distributed.run --nproc_per_node
    1`` (NCCL) of the train CLI with ``--mesh_data 1``, phase 15's f32 flags
    for 2 epochs: its ``2.pth`` bit-identical to phase 15's. (b) Two ranks
    sharing cuda:0 over gloo (NCCL takes one rank a card), one full-width
    train step (f32, train mode) at profile_train's batch of 8 × 300 frames,
    4 rows a rank, against one process on the 8: the loss within 1e-6
    relative, each gradient the optimizer receives (all-reduced, before the
    clip) within 1e-5 relative L2, parameters and EMA identical on both
    ranks after the step.
25. Sequence-parallel serving: two ranks sharing cuda:0 over gloo, the
    full-width SAID (random weights) on a 60-s clip (3600 frames, 1800 a
    rank), 1 and 20 DDIM and 25 DPM++ steps, CFG 2.0, injected latents,
    against the unsharded card run: MAE ≤ 1e-4, and max ≤ 1e-4 after one
    step; after 20 and 25 max ≤ 1e-3, or twice the deviation of the
    unsharded run with its GroupNorms moved to the split (measured in the
    same run; the chain amplifies a kernel's rounding, see SP_BOUND) where
    that is larger; the ranks' results identical; launches summed over the
    ranks exactly 2 × (flash 4 a step
    + the encoder's 12, the split GroupNorm's stats and apply 15 a step
    each, conv_0's GroupNorm 1, which takes the split; LayerNorm, GEGLU and
    the conv as phase 7), so the one-launch GroupNorm never runs on the
    sharded route; each request's wall time and share in collectives
    (the card synchronised around each ``all_gather``), labelled as two
    ranks sharing one card: a numerics check, not a speed figure; a
    ``{"sequence_parallel": ...}`` JSON line. Phase 2 holds K1 at the
    shard shape (2,1800,6×32) against (2,3600,6×32) keys, beside SDPA, and
    the split's stats and apply wrappers at (2,1800,192) with two shards'
    partials built in one process, against their twins and, joined,
    against the unsharded GroupNorm.
26. Sequence-parallel training: two ranks sharing cuda:0 over gloo, the
    full-width SAID (random weights, f32, train mode) and one train step at
    batch 2 of a 4200-frame bucket with 4190 real frames (2100 a rank, the
    real length ending inside rank 1), against one process on the card with
    the same batch and draws: the loss within 1e-5 relative, each gradient
    the optimizer receives within 1e-4 relative L2, all parameters and all
    EMA after the step together within 1e-6 relative L2, parameters and EMA
    identical on both ranks. The gathered 4200 keys take K1 with the
    window's length (past ``DENSE_MAX``) and the blockwise backward (past
    ``BWD_DENSE_MAX``); launches summed over the ranks exactly: K1 2 × 4,
    the masked split's stats and apply 2 × 15 each, the encoder's conv_0
    masked GroupNorm 2 × 1, no one-launch GroupNorm, LayerNorm and the conv
    2 × one process's; all_gathers a rank and the step's wall time (two
    ranks sharing one card: a numerics check, not a speed figure).
27. Tensor-parallel training: two ranks (model axis 2) sharing cuda:0 over
    gloo, one train step at phase 24b's batch (8 × 300-frame windows in the
    304-frame bucket, f32) and one validation step, against one process:
    loss, gradients (gathered whole), parameters and EMA as phase 26's (the
    clip counts each shard once), replicated parameters and EMA identical
    on both ranks, the validation loss within 1e-5 relative; launches
    summed over the ranks exactly twice one process's (activations are
    replicated), the validation step's K8 at I = 384 a rank. Phase 2 holds
    K1 with lengths at the SP-train shard (2,2100,6×32) against
    (2,4200,6×32) keys, the masked stats kernel at a rank's (2,2100,192)
    with a length inside the shard, and K8 at (8,300,192) with I = 384.

The last two lines are the kernels' JSON record (``ms``, ``plain_ms``
and ``library_ms`` with the host's enqueue counted, ``device_ms``,
``plain_device_ms`` and ``library_device_ms`` on the card alone, GEGLU's
and the conv's ``unfused_ms`` and ``unfused_device_ms`` beside them;
flash attention's, GEGLU's and the conv's bf16 headline beside the f32
one) and
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(2)

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from said_tpu_torch import _build  # noqa: E402
from said_tpu_torch.cli import inference as cli  # noqa: E402
from said_tpu_torch.cli import test_inference as eval_cli  # noqa: E402
from said_tpu_torch.cli._common import (  # noqa: E402
    ARKIT_BLENDSHAPES,
    build_said_model,
    configure_precision,
    random_init_,
)
from said_tpu_torch.data.blendvoca import PERSON_IDS_TEST  # noqa: E402
from said_tpu_torch.models.said import SAIDPipeline, process_audio, streaming_starts  # noqa: E402
from said_tpu_torch.ops import attention, conv, ffn, norms  # noqa: E402
from said_tpu_torch.optimize import native as qp_native  # noqa: E402

DEV = torch.device("cuda")
WORK = os.path.join(REPO, "build", "chip_smoke")
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 against f32 end to end (phase 5), relative to max |f32|: read 1.8e-2
# (embedding) and 1.2e-2 (denoiser) on an H100 and 2.3e-2 / 1.2e-2 on the
# CPU twins; a bf16 fault outside the kernels read 1.3e-1 on the CPU
BF16_BOUND = {"audio embedding": 5e-2, "denoiser output": 3e-2}
# card (kernels) against CPU (plain versions) at 2400 frames (phase 9),
# and bucketed against unbucketed at 3600 frames (phase 12), relative to
# max |reference|
LONG_BOUND = 1e-4
SR, FPS = 16000, 60
# sequence-parallel serving (phases 2 and 25): a 60-s clip on two ranks
SP_FRAMES = 60 * FPS
# sequence-parallel against the unsharded card run (phase 25): phase 4's
# bounds. A random-weight chain amplifies rounding: on an H100 the
# unsharded 60-s, 20-step DDIM run moved by max 1.23e-3 (MAE 8.1e-6) when
# only its GroupNorm kernel changed (one launch -> the split), at the same
# frames (~820-830) where the sharded run differed by 1.70e-3 (MAE
# 8.2e-6), and by 6e-8 after 1 step. So the max bound is phase 4's or
# SP_FLOOR_FACTOR times that swap's deviation, measured in the same run,
# whichever is larger; the MAE bound stays as it is.
SP_BOUND = {"mae": 1e-4, "max": 1e-3}
SP_FLOOR_FACTOR = 2.0
# data-parallel training on two ranks against one (phase 24b), as the CPU
# test holds it: the loss relative, each gradient relative L2
DP_BOUND = {"loss": 1e-6, "grad": 1e-5}
# sequence- and tensor-parallel training on two ranks against one (phases
# 26 and 27): the CPU tests' bounds against the JAX package (loss relative,
# each gradient relative L2); the parameters and EMA after the step, all
# tensors together, relative L2
PT_BOUND = {"loss": 1e-5, "grad": 1e-4, "params": 1e-6}
# phase 26's window: a 4200-frame bucket, 4190 real frames (2100 a rank)
SPT_FRAMES, SPT_REAL = 4200, 4190
# conv_0's output of a 10-s clip, where a "layer" feature extractor runs K7
LAYER_FEATURE_NORM_SHAPE = (1, 31999, 512)
# the BCVAE train step, card against CPU (phase 19), f32 with TF32 off:
# relative to the CPU's loss and running statistics, relative L2 per
# gradient (the train-mode BatchNorm backward cancels: the JAX package's
# own f32 gradients depart from float64 by up to 5e-5 on the CPU)
VAE_BOUND = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5}
# the card's peaks (NVIDIA's H100 SXM data sheet; the special-function
# rate for exp2 as the FlashAttention-3 paper gives it). Products (GEMM,
# attention, convolution) can run on the tensor cores: bf16 at its dense
# peak, f32 as 3xTF32, three TF32 products per f32 product, so at a third
# of TF32's 495 TFLOP/s. Elementwise work runs on the f32 FMA pipes.
HBM_BYTES_PER_S = 3.35e12
PRODUCT_FLOP_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
FMA_FLOP_PER_S = 67e12
EXP2_PER_S = 3.9e12

KERNELS = {  # name -> (wrapper, route, source, the TPU kernel it replaces: file:line, function)
    "group_norm": (norms.group_norm_kernel, "cuda", "said_tpu_torch/csrc/group_norm.cu",
                   "said_tpu/ops/pallas_norms.py:79", "group_norm_pallas"),
    "group_norm_masked": (norms.group_norm_masked_kernel, "cuda", "said_tpu_torch/csrc/group_norm.cu",
                          "said_tpu/ops/pallas_norms.py:133", "group_norm_masked_pallas"),
    "layer_norm": (norms.layer_norm_kernel, "cuda", "said_tpu_torch/csrc/layer_norm.cu",
                   "said_tpu/ops/pallas_norms.py:441", "layer_norm_pallas"),
    "geglu_ffn": (ffn.geglu_ffn_kernel, "cuda", "said_tpu_torch/csrc/geglu_ffn.cu",
                  "said_tpu/ops/pallas_ffn.py:87", "geglu_ffn_pallas"),
    "strided_conv_gelu": (conv.strided_conv_gelu_kernel, "cuda", "said_tpu_torch/csrc/strided_conv_gelu.cu",
                          "said_tpu/ops/pallas_conv.py:133", "strided_conv_gelu_pallas"),
    "flash_attention": (attention.flash_attention_kernel, "cuda", "said_tpu_torch/csrc/flash_attention.cu",
                        "said_tpu/ops/pallas_attention.py:186", "_flash_tpu_packed"),
    # the frame-sharded GroupNorm of sequence-parallel serving: the split's
    # two stages as two wrappers, the statistics joined across ranks between
    "group_norm_stats": (norms.group_norm_stats_kernel, "triton", "said_tpu_torch/ops/norms.py",
                         "said_tpu/ops/pallas_norms.py:249", "group_norm_pallas_blocked (stats phase, :284)"),
    "group_norm_apply": (norms.group_norm_apply_kernel, "triton", "said_tpu_torch/ops/norms.py",
                         "said_tpu/ops/pallas_norms.py:249", "group_norm_pallas_blocked (apply phase, :312)"),
}
ALSO_REPLACES = {
    "group_norm": "said_tpu/ops/pallas_norms.py:249 (group_norm_pallas_blocked)",
    "group_norm_masked": "said_tpu/ops/pallas_norms.py:338 (group_norm_masked_pallas_blocked)",
    "flash_attention": "said_tpu/ops/pallas_attention.py:322 (_flash_tpu_packed_blocked)",
}
# what each kernel's unfused yardstick computes (phase 2's "unfused" thunks;
# f32 with TF32 off, so at the kernel's precision)
UNFUSED = {"geglu_ffn": "F.linear, a*gelu(g), F.linear",
           "strided_conv_gelu": "F.gelu(F.conv1d(x.transpose(1, 2), w, stride=2))"}
# GroupNorm's wrappers take one of two routes by the shape's plan
# (norms.group_norm_plan): one launch of the CUDA kernel (the route above)
# or, past the threshold, the Triton split in two launches
SPLIT_ROUTE = {name: ("triton", "said_tpu_torch/ops/norms.py") for name in ("group_norm", "group_norm_masked")}


def check(ok, message):
    """Fail the run (a check that survives ``python -O``, unlike assert)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def randn(shape, seed, dtype=torch.float32, scale=1.0, offset=0.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale + offset
    return torch.from_numpy(a.astype(np.float32)).to(DEV, dtype)


def timed(fns, budget_ms=1500.0, max_iters=15):
    """Milliseconds per call of each thunk, two ways: ``enqueue``, the
    median of CUDA events around one call on an idle card, taken in turns
    (this counts the host's launch overhead, which dominates at small
    shapes); and ``device``, the card's own time: as many calls as turns
    captured in one CUDA graph and replayed between CUDA events, so the
    host launches nothing in between. The number of turns fits the slowest
    thunk into about ``budget_ms``."""
    def once(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def device_ms(fn, calls):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / calls

    for fn in fns.values():  # warm-up
        fn()
    slowest = max(once(fn) for fn in fns.values())
    iters = int(min(max_iters, max(3, budget_ms / max(slowest, 1e-3))))
    times = {name: [] for name in fns}
    for _ in range(iters):
        for name, fn in fns.items():
            times[name].append(once(fn))
    return {name: {"enqueue": float(np.median(times[name])), "device": device_ms(fn, iters)}
            for name, fn in fns.items()}


def bound(work, dtype):
    """Least time (ms) for a call's work and the term that binds."""
    terms = {"bytes": work["bytes"] / HBM_BYTES_PER_S,
             "operations": max(work.get("product_flop", 0.0) / PRODUCT_FLOP_PER_S[dtype],
                               work.get("flop", 0.0) / FMA_FLOP_PER_S,
                               work.get("exp2", 0.0) / EXP2_PER_S)}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def kernel_cases():
    """(kernel name, label, dtype, thunks {kernel, plain[, library]}, work,
    headline) per check; headline is "f32" for the case the kernel's JSON
    record holds, "bf16" for the bf16 record beside it (flash attention,
    GEGLU), else None. ``work`` counts bytes (each input read once, each
    output written once), the FLOP of products and of elementwise work,
    and exp2, for the bound."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        isz = torch.finfo(dt).bits // 8
        # the UNet at 10 s, 60 s and 6 min; the encoder's feature
        # projection and layers at 10 s, 50 s and 5 min; ragged
        # and the "layer" feature norm at conv_0 of a 10-s clip (C = 512)
        ln = [(2, 600, 192), (1, 600, 512), (1, 600, 768), (2, 37, 192), (2, 3600, 192), (2, 21600, 192),
              (1, 2999, 768), (1, 17999, 768), LAYER_FEATURE_NORM_SHAPE]
        for i, shape in enumerate(ln):
            c, n = shape[-1], int(np.prod(shape))
            plan = norms.layer_norm_plan(n // c, c, dt)
            x, w, b = randn(shape, 1, dt, 2.0, 0.5), randn((c,), 2), randn((c,), 3)
            fns = {"kernel": lambda x=x, w=w, b=b: norms.layer_norm_kernel(x, w, b, 1e-5),
                   "plain": lambda x=x, w=w, b=b: norms.layer_norm_plain(x, w, b, 1e-5)}
            if dt == torch.float32 or shape == LAYER_FEATURE_NORM_SHAPE:
                # (F.layer_norm on the card takes weights in x's dtype)
                fns["library"] = lambda x=x, w=w.to(dt), b=b.to(dt), c=c: torch.nn.functional.layer_norm(
                    x, (c,), w, b, 1e-5)
            if shape[1] >= 600:  # the main path's shapes: other plans, forced
                for lanes, per_block in ln_plans(n // c, c, dt):
                    fns[f"plan {lanes}x{per_block}"] = (lambda x=x, w=w, b=b, p=(lanes, per_block):
                                                      norms.layer_norm_kernel(x, w, b, 1e-5, _plan=p))
            label = f"{tag} {shape} [{plan.route} {plan.lanes}x{plan.chunks}, {plan.rows} rows x {plan.blocks} blocks]"
            headline = headline_tag(i == 0, tag) or ("layer feature norm " + tag
                                                     if shape == LAYER_FEATURE_NORM_SHAPE else None)
            cases.append(("layer_norm", label, dt, fns, {"bytes": 2 * n * isz + 8 * c, "flop": 8 * n}, headline))
        # the UNet at 10, 30, 60 s, a 4096-frame bucket and 6 min, the
        # encoder's conv_0 at a 4-s clip and a 32k-sample bucket; where the
        # last flag is set, every one-launch plan and the split are forced
        # and timed too
        gn = [((2, 600, 192), 32, 1e-5, "silu", False), ((2, 600, 192), 32, 1e-6, "none", True),
              ((1, 31999, 512), 512, 1e-5, "none", False), ((2, 37, 192), 32, 1e-5, "silu", False),
              ((2, 3600, 192), 32, 1e-6, "none", True), ((2, 21600, 192), 32, 1e-6, "none", True),
              ((2, 1800, 192), 32, 1e-6, "none", True), ((2, 4096, 192), 32, 1e-6, "none", True),
              ((1, 12799, 512), 512, 1e-5, "none", True)]
        for i, (shape, g, eps, act, every_plan) in enumerate(gn):
            c, n = shape[-1], int(np.prod(shape))
            x, w, b = randn(shape, 4, dt, 2.0, 30.0), randn((c,), 5), randn((c,), 6)
            fns = {"kernel": lambda x=x, g=g, w=w, b=b, eps=eps, act=act: norms.group_norm_kernel(x, g, w, b, eps, act),
                   "plain": lambda x=x, g=g, w=w, b=b, eps=eps, act=act: norms.group_norm_plain(x, g, w, b, eps, act)}
            if act == "none" and dt == torch.float32:
                # F.group_norm takes (N, C, T): the (B, T, C) tensor's transposed view
                fns["library"] = lambda x=x, g=g, w=w, b=b, eps=eps: torch.nn.functional.group_norm(
                    x.transpose(1, 2), g, w, b, eps)
            if every_plan:
                for plan in [*norms.cluster_plans(shape[1], c, g, dt), "split"]:
                    key = "plan split" if plan == "split" else f"plan {plan[0]}x{plan[1]}"
                    fns[key] = (lambda x=x, g=g, w=w, b=b, eps=eps, act=act, plan=plan:
                                norms.group_norm_kernel(x, g, w, b, eps, act, _plan=plan))
            cases.append(("group_norm", f"{tag} {shape} G={g} eps={eps} {act} {plan_label(shape, g, dt)}", dt, fns,
                          {"bytes": 2 * n * isz + 8 * c, "flop": 10 * n}, headline_tag(i == 1, tag)))
        # the UNet at the eval batch (CFG-doubled) and at a bucketed 60-s
        # clip; the encoder's conv_0 at the eval batch and a 60-s clip
        gnm = [((2, 512, 192), 32, 1e-5, "silu", [430, 258]),
               ((16, 512, 192), 32, 1e-5, "silu", [156, 204, 258, 306] * 4),
               ((2, 3840, 192), 32, 1e-6, "none", [3600, 3600]),
               ((8, 27305, 512), 512, 1e-5, "none", [13759] * 4 + [16319] * 4),
               ((1, 204799, 512), 512, 1e-5, "none", [191999]),
               ((3, 37, 192), 32, 1e-5, "silu", [37, 20, 1])]
        for i, (shape, g, eps, act, lengths) in enumerate(gnm):
            c, n = shape[-1], int(np.prod(shape))
            x, w, b = randn(shape, 4, dt, 2.0, 30.0), randn((c,), 5), randn((c,), 6)
            lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
            fns = {"kernel": lambda x=x, g=g, w=w, b=b, lens=lens, eps=eps, act=act:
                   norms.group_norm_masked_kernel(x, g, w, b, lens, eps, act),
                   "plain": lambda x=x, g=g, w=w, b=b, lens=lens, eps=eps, act=act:
                   norms.group_norm_masked_plain(x, g, w, b, lens, eps, act)}
            if shape == (16, 512, 192):  # the eval call: every one-launch plan, forced
                for plan in norms.cluster_plans(shape[1], shape[2], g, dt):
                    fns[f"plan {plan[0]}x{plan[1]}"] = (
                        lambda x=x, g=g, w=w, b=b, lens=lens, eps=eps, act=act, plan=plan:
                        norms.group_norm_masked_kernel(x, g, w, b, lens, eps, act, _plan=plan))
            label = f"{tag} {shape} G={g} eps={eps} {act} lengths {sorted(set(lengths))} {plan_label(shape, g, dt)}"
            cases.append(("group_norm_masked", label, dt, fns,
                          {"bytes": 2 * n * isz + 8 * c + 4 * shape[0], "flop": 10 * n}, headline_tag(i == 1, tag)))
        # the UNet at 10 s, 60 s and 6 min (CFG-folded batch 2), the eval
        # call (16 x 512), an unfolded 10-s call, and ragged
        geglu = [(2, 600, 192), (2, 3600, 192), (2, 21600, 192), (16, 512, 192), (1, 600, 192), (2, 37, 192),
                 (1, 1, 192)]
        for i, shape in enumerate(geglu):
            x = randn(shape, 7, dt)
            w1, b1 = randn((1536, 192), 8, dt, 0.05), randn((1536,), 9, scale=0.1)
            w2, b2 = randn((192, 768), 10, dt, 0.05), randn((192,), 11, scale=0.1)
            m = shape[0] * shape[1]
            fns = {"kernel": lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ffn.geglu_ffn_kernel(x, w1, b1, w2, b2),
                   "plain": lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ffn.geglu_ffn_plain(x, w1, b1, w2, b2),
                   "unfused": unfused_geglu_thunk(x, w1, b1, w2, b2)}
            if i < 4:  # the main path's shapes: every plan the kernel takes, forced
                for plan in ffn.PLANS[dt]:
                    fns[f"plan {plan[0]}x{plan[1]}"] = (lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2, plan=plan:
                                                        ffn.geglu_ffn_kernel(x, w1, b1, w2, b2, _plan=plan))
            work = {"bytes": 2 * m * 192 * isz + 3 * 768 * 192 * isz + 4 * (1536 + 192),
                    "product_flop": 2 * m * 192 * 1536 + 2 * m * 768 * 192}
            label = f"{tag} {shape} plan {ffn.geglu_plan(m, dt)}"
            cases.append(("geglu_ffn", label, dt, fns, work, tag if i == 0 else None))
        # conv_1 … conv_6 of a 10-s clip, conv_1 of a 60-s clip, ragged
        convs = [(3, 31999), (3, 15999), (3, 7999), (3, 3999), (2, 1999), (2, 999), (3, 191999), (3, 8), (2, 8)]
        for i, (k, t_in) in enumerate(convs):
            x, w = randn((1, t_in, 512), 12, dt), randn((k, 512, 512), 13, dt, 0.03)
            t_out = (t_in - k) // 2 + 1
            packed, torch_w = conv.pack_weight(w), w.permute(2, 1, 0).contiguous()  # torch's (C_out, C_in, K)
            fns = {"kernel": lambda x=x, w=packed: conv.strided_conv_gelu_kernel(x, w),
                   "plain": lambda x=x, w=w: conv.strided_conv_gelu_plain(x, w),
                   "unfused": lambda x=x, w=torch_w: torch.nn.functional.gelu(
                       torch.nn.functional.conv1d(x.transpose(1, 2), w, stride=2))}
            work = {"bytes": (t_in + t_out) * 512 * isz + k * 512 * 512 * isz,
                    "product_flop": 2 * t_out * k * 512 * 512}
            if i < 6:  # the six 10-s shapes: every split of the contraction, forced
                for split in conv.SPLITS:
                    fns[f"plan split {split}"] = (lambda x=x, w=packed, split=split:
                                                  conv.strided_conv_gelu_kernel(x, w, _split=split))
            plan = conv.conv_plan(t_out, 512, 512, dt)
            label = f"{tag} K={k} T_in={t_in} [{plan.route}, split {plan.split}, {plan.blocks} blocks]"
            cases.append(("strided_conv_gelu", label, dt, fns, work, tag if i == 0 else None))
        flash = [(2, 3600, 6, 32, None), (1, 3600, 12, 64, None), (2, 21600, 6, 32, None),
                 (1, 21600, 12, 64, None), (2, 2100, 6, 32, None), (3, 384, 6, 32, [384, 200, 0])]
        for i, (b, t, h, d, lengths) in enumerate(flash):
            q, k, v = (randn((b, t, h * d), 14 + j, dt) for j in range(3))
            lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=DEV)
            fns = {"kernel": lambda q=q, k=k, v=v, h=h, lens=lens: attention.flash_attention_kernel(q, k, v, h, lens),
                   "plain": lambda q=q, k=k, v=v, h=h, lens=lens: attention.flash_attention_plain(q, k, v, h, lens)}
            fns["library"] = sdpa_thunk(q, k, v, h, lengths)
            pairs = h * sum(min(n, t) ** 2 for n in (lengths or [t] * b))  # (query, key) pairs the data needs
            work = {"bytes": 4 * b * t * h * d * isz, "product_flop": 4 * pairs * d, "exp2": pairs}
            label = f"{tag} ({b}, {t}, {h}x{d})" + ("" if lengths is None else f" lengths {lengths}")
            cases.append(("flash_attention", label, dt, fns, work, tag if i == 0 else None))
        cases += sequence_parallel_cases(dt, tag, isz)
        cases += parallel_training_cases(dt, tag, isz)
    return cases


def sequence_parallel_cases(dt, tag, isz):
    """Phase 2's cases of sequence-parallel serving, a 60-s clip on two
    ranks (phase 25): K1 at a rank's shard, its 1800 queries against the
    gathered 3600 keys and values (the UNet's 6x32); and the frame-sharded
    GroupNorm's two stages at a rank's (2, 1800, 192), with both shards'
    partials built here in one process."""
    b, tq, s, h, d = 2, SP_FRAMES // 2, SP_FRAMES, 6, 32
    q = randn((b, tq, h * d), 50, dt)
    k, v = randn((b, s, h * d), 51, dt), randn((b, s, h * d), 52, dt)
    fns = {"kernel": lambda: attention.flash_attention_kernel(q, k, v, h),
           "plain": lambda: attention.flash_attention_plain(q, k, v, h), "library": sdpa_thunk(q, k, v, h, None)}
    pairs = h * b * tq * s
    work = {"bytes": (2 * tq + 2 * s) * b * h * d * isz, "product_flop": 4 * pairs * d, "exp2": pairs}
    cases = [("flash_attention", f"{tag} SP shard q ({b}, {tq}, {h}x{d}) k/v ({b}, {s}, {h}x{d})", dt, fns, work,
              f"sp {tag}")]
    x = randn((b, SP_FRAMES, 192), 53, dt, 2.0, 30.0)
    x0, x1 = (part.contiguous() for part in x.chunk(2, dim=1))
    w, bias = randn((192,), 54), randn((192,), 55)
    plan = norms.split_plan(b, tq, 192, 32)
    n = b * tq * 192
    fns = {"kernel": lambda: norms.group_norm_stats_kernel(x0, 32),
           "plain": lambda: norms.group_norm_partials_plain(x0, 32, plan.frames)}
    parts_bytes = 3 * b * 32 * plan.chunks * 4
    cases.append(("group_norm_stats", f"{tag} ({b}, {tq}, 192) G=32 [{plan.chunks} chunks of {plan.frames}]", dt,
                  fns, {"bytes": n * isz + parts_bytes, "flop": 4 * n}, tag))
    parts = torch.cat([norms.group_norm_stats_kernel(x0, 32), norms.group_norm_stats_kernel(x1, 32)], dim=3)
    fns = {"kernel": lambda: norms.group_norm_apply_kernel(x0, 32, w, bias, parts, 1e-6),
           "plain": lambda: norms.group_norm_join_plain(x0, 32, w, bias, parts, 1e-6)}
    cases.append(("group_norm_apply", f"{tag} ({b}, {tq}, 192) G=32, 2 shards' {parts.shape[3]} partials", dt, fns,
                  {"bytes": 2 * n * isz + 2 * parts_bytes + 8 * 192, "flop": 10 * n}, tag))
    return cases


def parallel_training_cases(dt, tag, isz):
    """Phase 2's cases of sequence- and tensor-parallel training (phases 26
    and 27): K1 at a rank's shard of the 4200-frame window, its 2100
    queries against the gathered keys with the window's 4190 real frames;
    the masked stats kernel at a rank's (2, 2100, 192) with rank 1's 2090
    real frames; K8 at phase 27's (8, 300, 192) with a rank's I = 384."""
    b, tq, s, h, d = 2, SPT_FRAMES // 2, SPT_FRAMES, 6, 32
    q = randn((b, tq, h * d), 56, dt)
    k, v = randn((b, s, h * d), 57, dt), randn((b, s, h * d), 58, dt)
    lengths = [SPT_REAL] * b
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    fns = {"kernel": lambda lens=lens: attention.flash_attention_kernel(q, k, v, h, lens),
           "plain": lambda lens=lens: attention.flash_attention_plain(q, k, v, h, lens),
           "library": sdpa_thunk(q, k, v, h, lengths)}
    pairs = h * b * tq * SPT_REAL  # every local query row is live; keys past 4190 masked
    work = {"bytes": (2 * tq + 2 * s) * b * h * d * isz + 4 * b, "product_flop": 4 * pairs * d, "exp2": pairs}
    cases = [("flash_attention", f"{tag} SP train shard q ({b}, {tq}, {h}x{d}) k/v ({b}, {s}, {h}x{d}) lengths "
              f"{lengths}", dt, fns, work, f"sp train {tag}")]
    x = randn((b, tq, 192), 59, dt, 2.0, 30.0)
    real = SPT_REAL - tq
    lens = torch.full((b,), real, dtype=torch.int32, device=DEV)
    plan = norms.split_plan(b, tq, 192, 32)
    n = b * real * 192
    fns = {"kernel": lambda x=x, lens=lens: norms.group_norm_stats_kernel(x, 32, lens),
           "plain": lambda x=x, lens=lens: norms.group_norm_partials_plain(x, 32, plan.frames, lens)}
    cases.append(("group_norm_stats", f"{tag} ({b}, {tq}, 192) G=32 masked, {real} real [{plan.chunks} chunks of "
                  f"{plan.frames}]", dt, fns, {"bytes": n * isz + 3 * b * 32 * plan.chunks * 4 + 4 * b,
                                              "flop": 4 * n}, f"masked {tag}"))
    x = randn((8, 300, 192), 60, dt)
    w1, b1 = randn((768, 192), 61, dt, 0.05), randn((768,), 62, scale=0.1)
    w2, b2 = randn((192, 384), 63, dt, 0.05), randn((192,), 64, scale=0.1)
    m = 8 * 300
    fns = {"kernel": lambda: ffn.geglu_ffn_kernel(x, w1, b1, w2, b2),
           "plain": lambda: ffn.geglu_ffn_plain(x, w1, b1, w2, b2), "unfused": unfused_geglu_thunk(x, w1, b1, w2, b2)}
    work = {"bytes": 2 * m * 192 * isz + 3 * 384 * 192 * isz + 4 * (768 + 192),
            "product_flop": 2 * m * 192 * 768 + 2 * m * 384 * 192}
    cases.append(("geglu_ffn", f"{tag} TP shard (8, 300, 192) I=384 plan {ffn.geglu_plan(m, dt, inner=384)}", dt, fns,
                  work, f"tp {tag}"))
    return cases


def check_sharded_group_norm():
    """Phase 2: the two shards' applies joined against the unsharded
    GroupNorm of the whole (2, 3600, 192), within phase 2's bounds."""
    for dt in (torch.float32, torch.bfloat16):
        x = randn((2, SP_FRAMES, 192), 53, dt, 2.0, 30.0)
        w, b = randn((192,), 54), randn((192,), 55)
        shards = [part.contiguous() for part in x.chunk(2, dim=1)]
        parts = torch.cat([norms.group_norm_stats_kernel(xs, 32) for xs in shards], dim=3)
        got = torch.cat([norms.group_norm_apply_kernel(xs, 32, w, b, parts, 1e-6) for xs in shards], dim=1)
        want = norms.group_norm_plain(x, 32, w, b, 1e-6)
        err = (got.float() - want.float()).abs().max().item()
        limit = BOUND[dt] * want.float().abs().max().item()
        print(f"frame-sharded GroupNorm, 2 shards joined, against the unsharded twin of {tuple(x.shape)} {dt}: "
              f"max abs err {err:.3e} limit {limit:.3e}")
        check(err <= limit, f"frame-sharded GroupNorm {dt}: {err} > {limit}")


def ln_plans(rows, c, dtype):
    """LayerNorm plans (lanes a row, rows a block) beside the chosen one:
    half and twice its lanes, at 64, 128 and 256 threads a block, where
    the kernel takes them."""
    chosen = norms.layer_norm_plan(rows, c, dtype).lanes
    plans = []
    for lanes in {chosen // 2, chosen, chosen * 2} - {0}:
        for threads in (64, 128, 256):
            try:
                norms.layer_norm_forced_plan(rows, c, dtype, lanes, threads // lanes)
            except ValueError:
                continue
            plans.append((lanes, threads // lanes))
    return sorted(plans)


def headline_tag(first, tag):
    return "f32" if first and tag == "f32" else None


def plan_label(shape, num_groups, dtype):
    """A GroupNorm case's plan and route: one launch (groups a block x
    cluster size, CTAs) or the split (chunks)."""
    b, t, c = shape
    plan = norms.group_norm_plan(b, t, c, num_groups, dtype)
    if plan.route == "cuda":
        ctas = b * (num_groups // plan.groups) * plan.cluster
        return f"[cuda one launch {plan.groups}x{plan.cluster}, {ctas} CTAs]"
    return f"[triton split, {plan.chunks} chunks of {plan.frames}]"


def unfused_geglu_thunk(x, w1, b1, w2, b2):
    """The feed-forward as three unfused calls in the working dtype
    (``F.linear``, the gate ``a·gelu(g)``, ``F.linear``; f32 with TF32
    off), a timing yardstick only (the port never calls it): its (rows,
    1536) projection goes through device memory."""
    b1d, b2d = b1.to(x.dtype), b2.to(x.dtype)

    def run():
        a, g = torch.nn.functional.linear(x, w1, b1d).chunk(2, dim=-1)
        return torch.nn.functional.linear(a * torch.nn.functional.gelu(g), w2, b2d)

    return run


def sdpa_thunk(q, k, v, h, lengths):
    """``scaled_dot_product_attention`` on the (B, H, T, D) views of the
    packed tensors, a timing yardstick only (the port never calls it).
    Its math backend is excluded: in f32 at 21600 frames it would build
    22 GB of scores. Lengths become a key mask (a length-0 row then gives
    NaN there, not zeros; only its time is used)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, _, inner = q.shape
    qh, kh, vh = (x.view(b, x.shape[1], h, inner // h).transpose(1, 2) for x in (q, k, v))
    mask = None
    if lengths is not None:
        s = k.shape[1]
        mask = (torch.arange(s, device=DEV)[None, :] < torch.tensor(lengths, device=DEV)[:, None])[:, None, None, :]

    def run():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    return run


def phase_kernels(record):
    print("\n== phase 2: kernels against their plain twins (card) ==")
    for name, label, dt, fns, work, headline in kernel_cases():
        got, ref = fns["kernel"](), fns["plain"]()
        torch.cuda.synchronize()
        out_dt = torch.float32 if name == "group_norm_stats" else dt  # the partials are f32
        check(got.dtype == out_dt and ref.dtype == out_dt and got.shape == ref.shape,
              f"{name} {label}: dtype/shape differ from the twin")
        err = (got.float() - ref.float()).abs().max().item()
        limit = BOUND[dt] * ref.float().abs().max().item()
        ok = err <= limit and np.isfinite(err)
        for key in [k for k in fns if k.startswith("plan ")]:  # forced plans: as close, and bit-stable
            a, b = fns[key](), fns[key]()
            plan_err = (a.float() - ref.float()).abs().max().item()
            check(plan_err <= limit and torch.equal(a, b), f"{name} {label} {key}: max abs err {plan_err} "
                  f"(limit {limit}) or two calls differ")
        ms = timed(fns)
        bound_ms, bound_by = bound(work, dt)
        dev = {k: v["device"] for k, v in ms.items()}
        versus = "none" if "library" not in ms else (
            f"{dev['library']:.4f} ms (with enqueue {ms['library']['enqueue']:.4f}) "
            f"kernel/library {dev['kernel'] / dev['library']:.2f}")
        extra = "".join(f" {k} {dev[k]:.4f} ms" for k in ms if k.startswith("plan "))
        if "unfused" in ms:
            extra = (f" unfused ({UNFUSED[name]}) {dev['unfused']:.4f} ms (with enqueue "
                     f"{ms['unfused']['enqueue']:.4f}) kernel/unfused {dev['kernel'] / dev['unfused']:.2f}{extra}")
        print(f"{name:18s} {label:40s} max_abs_err {err:.3e} limit {limit:.3e} on the card alone: kernel "
              f"{dev['kernel']:.4f} ms (with enqueue {ms['kernel']['enqueue']:.4f}) plain {dev['plain']:.4f} ms "
              f"library {versus} bound {bound_ms:.4f} ms ({bound_by}){extra} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label}: max abs err {err} > limit {limit}")
        if headline:
            # ms, plain_ms, library_ms, unfused_ms: CUDA events around one
            # call, the host's enqueue counted; device_ms and its kin: the
            # card alone
            library = ms.get("library", {})
            entry = dict(max_abs_err=err, ms=ms["kernel"]["enqueue"], plain_ms=ms["plain"]["enqueue"],
                         library_ms=library.get("enqueue"), device_ms=dev["kernel"], plain_device_ms=dev["plain"],
                         library_device_ms=library.get("device"), bound_ms=bound_ms, bound_by=bound_by, shape=label)
            plans = {k[5:]: v for k, v in dev.items() if k.startswith("plan ")}
            if plans:
                entry["plan_device_ms"] = plans
            if "unfused" in ms:
                entry.update(unfused_ms=ms["unfused"]["enqueue"], unfused_device_ms=dev["unfused"])
            if headline == "f32":
                record[name].update(entry)
            else:  # "bf16" or another labelled record beside the headline
                record[name][headline] = entry


def write_wav(path, seconds, seed):
    """Synthetic speech-like audio: AM-modulated harmonics plus noise."""
    from scipy.io import wavfile

    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voice = sum(np.sin(k * phase) / k for k in range(1, 8))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t)) ** 2
    x = 0.2 * voice * envelope + 0.01 * rng.standard_normal(t.shape)
    wavfile.write(path, SR, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def read_csv(path):
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], dtype=np.float64)


def expected_launches(steps, bucketed=False, calls=1):
    """Kernel launches of ``calls`` CFG pipeline calls of ``steps`` denoise
    steps at full width whose clip is longer than the dense limit: per
    step 15 GroupNorms, 12 LayerNorms, 4 GEGLUs, 4 UNet self-attentions;
    per call the encoder's conv_0 GroupNorm, 26 LayerNorms, 6 strided
    convs and 12 self-attentions. In bucketed mode every GroupNorm is the
    masked one."""
    norm = 15 * steps + 1
    per_call = {"group_norm": 0 if bucketed else norm, "group_norm_masked": norm if bucketed else 0,
                "layer_norm": 12 * steps + 26, "geglu_ffn": 4 * steps, "strided_conv_gelu": 6,
                "flash_attention": 4 * steps + 12, "group_norm_stats": 0, "group_norm_apply": 0}
    return {name: calls * n for name, n in per_call.items()}


def zero_launches():
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


def cli_request(record, gpu_line, phase, seconds, steps, flags, expected, seed):
    """One request through the CLI on the card; the launch counters are
    zeroed just before it and read just after."""
    frames = int(seconds * FPS)
    print(f"\n== phase {phase}: one {seconds:g}-s request through the CLI ({frames} frames, {steps} steps "
          f"{' '.join(flags) or 'DDIM'}, CFG 2.0, f32) ==")
    wav, out = os.path.join(WORK, f"clip{seconds:g}s.wav"), os.path.join(WORK, f"clip{seconds:g}s.csv")
    write_wav(wav, seconds, seed=seed)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["--device", "cuda", "--num_steps", str(steps), "--guidance_scale", "2.0", "--dtype", "float32",
              "--seed", "0", "--weights_path", "", "--audio_path", wav, "--output_path", out, *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    header, coeffs = read_csv(out)
    print(f"request wall time {wall:.2f} s (model build + random init + prepare + {steps} steps + CSV) on {gpu_line}")
    print(f"launch counts in the request: {launches}")
    print(f"CSV: {coeffs.shape[0]} rows x {len(header)} columns, min {coeffs.min():.4f} max {coeffs.max():.4f} "
          f"std {coeffs.std():.4f}")
    check(tuple(header) == ARKIT_BLENDSHAPES, f"CSV header {header}")
    check(coeffs.shape == (frames, 32), f"CSV holds {coeffs.shape}, expected ({frames}, 32)")
    check(np.isfinite(coeffs).all() and coeffs.min() >= 0.0 and coeffs.max() <= 1.0, "CSV values not finite in [0, 1]")
    check(launches == expected, f"launch counts {launches} != {expected}")
    for name, n in launches.items():
        record[name].setdefault("launches_by_request", {})[f"{seconds:g}s {steps} steps {' '.join(flags)}".strip()] = n
    return wall


def phase_request(record, gpu_line):
    expected = dict(expected_launches(1000), flash_attention=0)  # 600 frames: dense self-attention
    cli_request(record, gpu_line, 3, 10.0, 1000, [], expected, seed=0)
    for name in KERNELS:
        if name not in ("flash_attention", "group_norm_masked"):
            record[name]["launches"] = record[name]["launches_by_request"]["10s 1000 steps"]


def phase_long_requests(record, gpu_line):
    """Phases 7 and 8; returns the 6-min request's wall time."""
    cli_request(record, gpu_line, 7, 60.0, 1000, [], expected_launches(1000), seed=2)
    record["flash_attention"]["launches"] = record["flash_attention"]["launches_by_request"]["60s 1000 steps"]
    return cli_request(record, gpu_line, 8, 360.0, 25, ["--solver", "dpmpp_2m"], expected_launches(25), seed=3)


def phase_long_card_vs_cpu():
    print("\n== phase 9: card (flash kernel) against CPU (its plain version), 40-s clip (2400 frames) ==")
    frames = 2400
    configure_precision("float32")
    cpu_model = random_init_(build_said_model(), seed=0).eval()
    card_model = copy.deepcopy(cpu_model).to(DEV)
    rng = np.random.default_rng(4)
    wave = process_audio(0.1 * rng.standard_normal(40 * SR).astype(np.float32))
    latents = rng.standard_normal((1, frames, 32)).astype(np.float32)
    out = {}
    attention.flash_attention_kernel.launches = 0
    for name, model, dev in (("card", card_model, DEV), ("cpu", cpu_model, torch.device("cpu"))):
        pipe = SAIDPipeline(model)
        wave_t, lat = torch.from_numpy(wave).to(dev), torch.from_numpy(latents).to(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            emb = model.get_audio_embedding(wave_t, frames)
            kv, table = pipe.prepare(wave_t, frames, True)
            eps = model.unet(lat, kv_caches=kv, emb=table[999], cfg_fold=True)
        out[name] = {"audio embedding": emb.cpu(), "denoiser output": eps.cpu()}
        print(f"{name}: embedding {tuple(emb.shape)}, denoiser output {tuple(eps.shape)} "
              f"in {time.perf_counter() - t0:.1f} s")
    launches = attention.flash_attention_kernel.launches
    check(launches == 12 + 12 + 4, f"flash launches on the card {launches} != 28 (two encoder runs, one denoiser call)")
    for name in ("audio embedding", "denoiser output"):
        want, got = out["cpu"][name], out["card"][name]
        rel = ((got - want).abs().max() / want.abs().max()).item()
        std = want.std().item()
        print(f"{name:16s} card vs CPU: max {rel:.3e} relative to max |CPU| (bound {LONG_BOUND:.0e}), CPU std {std:.4f}")
        check(got.shape == want.shape and std > 1e-3, f"{name}: shapes differ or the output is degenerate")
        check(np.isfinite(rel) and rel <= LONG_BOUND, f"card vs CPU {name} at {frames} frames: {rel:.3e} > {LONG_BOUND}")


EVAL_CLIPS_S = ((2.6, 3.4), (4.3, 5.1))  # per test person: sentence01, sentence02


def eval_run(record, gpu_line, label, flags, expected, split, out_dir):
    """One run of the eval-generation CLI on the card; the launch
    counters are zeroed just before it and read just after. Returns the
    CSVs written."""
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = eval_cli.main(["--device", "cuda", "--guidance_scale", "2.0", "--dtype", "float32", "--seed", "0",
                             "--weights_path", "", "--audio_dir", split, "--output_dir", out_dir, *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"{label}: wall time {wall:.2f} s (model build + random init + every call + CSVs) on {gpu_line}")
    print(f"launch counts in the run: {launches}")
    check(launches == expected, f"launch counts {launches} != {expected}")
    for name, n in launches.items():
        record[name].setdefault("launches_by_request", {})[label] = n
    check(len(written) == len(set(written)) == 32, f"{len(written)} CSVs written, expected 32 distinct")
    for pid, seconds in zip(PERSON_IDS_TEST, EVAL_CLIPS_S):
        for sid, sec in enumerate(seconds, start=1):
            for k in range(8):
                header, coeffs = read_csv(os.path.join(out_dir, pid, f"sentence{sid:02}-{k}.csv"))
                rows = int(int(sec * SR) / SR * FPS)  # the CLI's window of the clip write_wav wrote
                check(tuple(header) == ARKIT_BLENDSHAPES and coeffs.shape == (rows, 32),
                      f"{pid}/sentence{sid:02}-{k}.csv holds {coeffs.shape}, expected ({rows}, 32)")
                check(np.isfinite(coeffs).all() and coeffs.min() >= 0.0 and coeffs.max() <= 1.0,
                      f"{pid}/sentence{sid:02}-{k}.csv: values not finite in [0, 1]")
    return wall


def phase_eval_cli(record, gpu_line):
    print("\n== phase 10: the eval-generation CLI on a synthetic test split (2 persons x 2 sentences of "
          "2.6, 3.4, 4.3 and 5.1 s; bucket 256; CFG 2.0, f32) ==")
    split = os.path.join(WORK, "eval_split")
    for pid, seconds in zip(PERSON_IDS_TEST, EVAL_CLIPS_S):
        os.makedirs(os.path.join(split, pid), exist_ok=True)
        for sid, sec in enumerate(seconds, start=1):
            write_wav(os.path.join(split, pid, f"sentence{sid:02}.wav"), sec, seed=10 * sid + len(pid))
    # one call per clip (8 repeats in one batch of 8): one length per call
    label = "eval 4 clips x 8, 1000 steps"
    eval_run(record, gpu_line, label, ["--num_repeats", "8", "--batch_size", "8", "--num_steps", "1000"],
             expected_launches(1000, bucketed=True, calls=4) | {"flash_attention": 0},
             split, os.path.join(WORK, "eval_out"))
    record["group_norm_masked"]["launches"] = record["group_norm_masked"]["launches_by_request"][label]
    # 32 (clip, repeat) tasks sorted by length in batches of 12: 8 x 156 +
    # 4 x 204 frames, then 4 x 204 + 8 x 258, then 8 x 306 — 3 calls, the
    # first two holding two clips each, with per-row lengths
    eval_run(record, gpu_line, "eval mixed batching, 3 batches, 100 steps",
             ["--num_repeats", "8", "--batch_size", "12", "--num_steps", "100", "--mixed_batching"],
             expected_launches(100, bucketed=True, calls=3) | {"flash_attention": 0},
             split, os.path.join(WORK, "eval_mixed_out"))


def phase_mixed_lengths():
    print("\n== phase 11: mixed lengths (2.0, 3.3, 4.3 s in one bucketed batch, bucket 256, 20 steps): "
          "each row against its own unbucketed run, and card against CPU ==")
    configure_precision("float32")
    cpu_model = random_init_(build_said_model(), seed=0).eval()
    card = SAIDPipeline(copy.deepcopy(cpu_model).to(DEV))
    rng = np.random.default_rng(6)
    waves = [process_audio(0.1 * rng.standard_normal(int(sec * SR)).astype(np.float32))[0] for sec in (2.0, 3.3, 4.3)]
    lens = np.array([len(w) for w in waves])
    frames = [int(n / SR * FPS) for n in lens]
    batch = np.zeros((3, lens.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    latents = rng.standard_normal((3, max(frames), 32)).astype(np.float32)
    kw = dict(num_inference_steps=20, guidance_scale=2.0)
    mixed = dict(latents=latents, length_bucket=256, waveform_lengths=lens, **kw)
    t0 = time.perf_counter()
    res_card = card.inference(batch, **mixed).result
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_cpu = SAIDPipeline(cpu_model).inference(batch, **mixed).result
    t_cpu = time.perf_counter() - t0
    print(f"mixed batch {res_card.shape}: card {t_card:.1f} s, cpu {t_cpu:.1f} s")
    with torch.no_grad():
        t_a_pad = max(-(-res_card.shape[1] * SR // FPS), lens.max())  # the pipeline's padded waveform
        wave_t = torch.from_numpy(np.pad(batch, ((0, 0), (0, t_a_pad - lens.max())))).to(DEV)
        kv, table = card.prepare(wave_t, res_card.shape[1], True, lens, np.array(frames))
        lat = torch.from_numpy(np.pad(latents, ((0, 0), (0, res_card.shape[1] - latents.shape[1]), (0, 0)))).to(DEV)
        seq = torch.tensor(frames * 2, dtype=torch.int32, device=DEV)
        eps = card.model.unet(torch.cat([lat, lat]), kv_caches=kv, emb=table[999], seq_len_real=seq)
    eps_std = torch.cat([eps[i, :n] for i, n in enumerate(frames * 2)]).std().item()
    print(f"bucketed denoiser output std on the real frames {eps_std:.4f} (must be > 1e-3)")
    check(eps_std > 1e-3, "denoiser output is degenerate; the comparisons would be vacuous")
    for i, n in enumerate(frames):
        single = card.inference(waves[i][None], latents=latents[i : i + 1, :n], **kw).result[0]
        for name, want in (("own unbucketed run", single), ("CPU", res_cpu[i, :n])):
            diff = np.abs(res_card[i, :n] - want)
            print(f"row {i} ({n} frames) against {name}: MAE {diff.mean():.3e} (bound 1e-4) "
                  f"max {diff.max():.3e} (bound 1e-3)")
            check(diff.mean() <= 1e-4 and diff.max() <= 1e-3, f"row {i} against {name}: MAE {diff.mean():.3e} "
                  f"/ max {diff.max():.3e}")


def phase_bucketed_long(record, gpu_line):
    # count the flash launches that pass a lengths pointer, at the C entry
    # point the kernel's wrapper calls
    lib = _build.library()
    entry, seen = lib.said_flash_attention, []

    def spy(q, k, v, out, lengths, *rest):
        seen.append(lengths is not None)
        return entry(q, k, v, out, lengths, *rest)

    lib.said_flash_attention = spy
    cli_request(record, gpu_line, 12, 60.0, 25, ["--solver", "dpmpp_2m", "--length_bucket", "256"],
                expected_launches(25, bucketed=True), seed=5)
    lib.said_flash_attention = entry
    check(len(seen) == 4 * 25 + 12 and all(seen), f"{sum(seen)} of {len(seen)} flash launches took lengths")
    print(f"every one of the {len(seen)} flash launches took lengths")

    print("bucketed (3840 frames, 3600 real) against unbucketed (3600), same weights and latents:")
    configure_precision("float32")
    model = random_init_(build_said_model(), seed=0).to(DEV).eval()
    pipe = SAIDPipeline(model)
    rng = np.random.default_rng(7)
    wave = process_audio(0.1 * rng.standard_normal(60 * SR).astype(np.float32))
    latents = rng.standard_normal((1, 3600, 32)).astype(np.float32)
    out = {}
    with torch.no_grad():
        for name, t_a, frames, real in (("unbucketed", 60 * SR, 3600, None), ("bucketed", 1024000, 3840, 3600)):
            wave_t = torch.from_numpy(np.pad(wave, ((0, 0), (0, t_a - wave.shape[1])))).to(DEV)
            lat = torch.from_numpy(np.pad(latents, ((0, 0), (0, frames - 3600), (0, 0)))).to(DEV)
            lengths = (None, None) if real is None else (60 * SR, real)
            emb = model.get_audio_embedding(wave_t, frames, *lengths)
            kv, table = pipe.prepare(wave_t, frames, True, *lengths)
            eps = model.unet(lat, kv_caches=kv, emb=table[999], cfg_fold=True, seq_len_real=real)
            out[name] = {"audio embedding": emb[:, :3600].cpu(), "denoiser output": eps[:, :3600].cpu()}
    for name in ("audio embedding", "denoiser output"):
        want, got = out["unbucketed"][name], out["bucketed"][name]
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"{name:16s} bucketed vs unbucketed: max {rel:.3e} relative to max |unbucketed| "
              f"(bound {LONG_BOUND:.0e}), std {want.std().item():.4f}")
        check(want.std().item() > 1e-3, f"{name}: the output is degenerate")
        check(np.isfinite(rel) and rel <= LONG_BOUND, f"bucketed vs unbucketed {name}: {rel:.3e} > {LONG_BOUND}")


def phase_card_vs_cpu():
    print("\n== phase 4: card (kernels) against CPU (plain twins), 4-s clip, 20 steps ==")
    configure_precision("float32")
    model = random_init_(build_said_model(), seed=0).eval()
    rng = np.random.default_rng(1)
    wave = process_audio(0.1 * rng.standard_normal(4 * SR).astype(np.float32))
    latents = rng.standard_normal((1, 240, 32)).astype(np.float32)
    kw = dict(num_inference_steps=20, guidance_scale=2.0, latents=latents)
    t0 = time.perf_counter()
    res_cpu = SAIDPipeline(model).inference(wave, **kw).result
    t_cpu = time.perf_counter() - t0
    pipe = SAIDPipeline(model.to(DEV))
    t0 = time.perf_counter()
    res_gpu = pipe.inference(wave, **kw).result
    t_gpu = time.perf_counter() - t0
    with torch.no_grad():
        kv, table = pipe.prepare(torch.from_numpy(wave).to(DEV), 240, True)
        eps = pipe.model.unet(torch.from_numpy(latents).to(DEV), kv_caches=kv, emb=table[999], cfg_fold=True)
    eps_std = eps.std().item()
    diff = np.abs(res_gpu - res_cpu)
    print(f"coefficient MAE {diff.mean():.3e} (bound 1e-4)  max {diff.max():.3e} (bound 1e-3)  "
          f"denoiser output std {eps_std:.4f} (must be > 1e-3)  cpu {t_cpu:.1f} s  card {t_gpu:.1f} s")
    check(res_gpu.shape == res_cpu.shape == (1, 240, 32), f"shapes {res_gpu.shape} / {res_cpu.shape}")
    check(eps_std > 1e-3, "denoiser output is degenerate; the comparison would be vacuous")
    check(diff.mean() <= 1e-4 and diff.max() <= 1e-3, f"card vs CPU MAE {diff.mean():.3e} / max {diff.max():.3e}")
    return model, wave, latents


def phase_bf16_vs_f32(model, wave, latents):
    print("\n== phase 5: bfloat16 against float32 on the card (phase 4's weights, clip and latents) ==")
    bf16 = build_said_model(dtype="bfloat16")
    bf16.load_state_dict(model.state_dict(), strict=True)
    wave_t, lat = torch.from_numpy(wave).to(DEV), torch.from_numpy(latents).to(DEV)
    out = {}
    with torch.no_grad():
        for m in (model, bf16.to(DEV).eval()):
            kv, table = SAIDPipeline(m).prepare(wave_t, 240, True)
            out[m.dtype] = {"audio embedding": m.get_audio_embedding(wave_t, 240).float(),
                            "denoiser output": m.unet(lat, kv_caches=kv, emb=table[999], cfg_fold=True).float()}
    for name, bound in BF16_BOUND.items():
        want, got = out[torch.float32][name], out[torch.bfloat16][name]
        rel_max = ((got - want).abs().max() / want.abs().max()).item()
        rel_mean = ((got - want).abs().mean() / want.abs().mean()).item()
        print(f"{name:16s} bf16 vs f32: max {rel_max:.3e} (bound {bound:.0e}) mean {rel_mean:.3e}, "
              f"relative to max / mean |f32|")
        check(got.shape == want.shape and np.isfinite(rel_max) and rel_max <= bound,
              f"bf16 {name} departs from f32 by {rel_max:.3e} > {bound}")


def phase_bf16():
    print("\n== phase 6: bfloat16 request (4-s clip, 100 steps) against the same f32 request ==")
    wav = os.path.join(WORK, "clip4s.wav")
    write_wav(wav, 4.0, seed=1)
    out = {}
    for dtype in ("float32", "bfloat16"):
        path = os.path.join(WORK, f"clip4s_{dtype}.csv")
        t0 = time.perf_counter()
        cli.main(["--device", "cuda", "--num_steps", "100", "--dtype", dtype, "--seed", "0",
                  "--weights_path", "", "--audio_path", wav, "--output_path", path])
        torch.cuda.synchronize()
        header, out[dtype] = read_csv(path)
        print(f"{dtype}: {out[dtype].shape} in {time.perf_counter() - t0:.2f} s")
    bf = out["bfloat16"]
    check(bf.shape == (240, 32) and np.isfinite(bf).all() and bf.min() >= 0.0 and bf.max() <= 1.0,
          "bf16 CSV is not (240, 32) finite values in [0, 1]")
    print(f"bf16 vs f32 coefficient MAE {np.abs(bf - out['float32']).mean():.3e} (for information)")


# ------------------------------------------------------------- training


def rel_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def autograd_cases():
    """(label, dtype, wrapper thunk, plain thunk, inputs needing a gradient,
    lengths) per check of phase 2b: each thunk maps the inputs to an
    output; the wrapper is the router (kernel forward, its
    ``torch.autograd.Function`` backward), the plain thunk its plain twin,
    differentiated by autograd."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        w, b = randn((192,), 5).requires_grad_(), randn((192,), 6).requires_grad_()
        for shape, lengths in (((2, 600, 192), None), ((2, 600, 192), [597, 597]), ((8, 304, 192), [297] * 8)):
            x = randn(shape, 4, dt, 2.0, 0.5).requires_grad_()
            if lengths is None:
                cases.append((f"group_norm {tag} {shape} silu", dt,
                              lambda x, w, b: norms.group_norm(x, 32, w, b, 1e-5, "silu"),
                              lambda x, w, b: norms.group_norm_plain(x, 32, w, b, 1e-5, "silu"), (x, w, b), None))
            else:
                lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
                cases.append((f"group_norm_masked {tag} {shape} silu lengths {sorted(set(lengths))}", dt,
                              lambda x, w, b, lens=lens: norms.group_norm_masked(x, 32, w, b, lens, 1e-5, "silu"),
                              lambda x, w, b, lens=lens: norms.group_norm_masked_plain(x, 32, w, b, lens, 1e-5, "silu"),
                              (x, w, b), lengths))
            cases.append((f"layer_norm {tag} {shape}", dt, lambda x, w, b: norms.layer_norm(x, w, b),
                          lambda x, w, b: norms.layer_norm_plain(x, w, b), (x, w, b), None))
        # past the dense limit: 2400 keys take the dense-recompute backward,
        # 4200 the blockwise one
        for b_, t, lengths in ((1, 2400, None), (2, 2400, [2400, 2100]), (1, 4200, None)):
            q, k, v = (randn((b_, t, 192), 14 + j, dt).requires_grad_() for j in range(3))
            lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=DEV)
            label = f"flash_attention {tag} ({b_}, {t}, 6x32)" + ("" if lengths is None else f" lengths {lengths}")
            cases.append((label, dt, lambda q, k, v, lens=lens: attention.self_attention(q, k, v, 6, lens),
                          lambda q, k, v, lens=lens: attention.flash_attention_plain(q, k, v, 6, lens), (q, k, v),
                          lengths))
    x = randn((2, 600, 192), 7).requires_grad_()
    w1, b1 = randn((1536, 192), 8, scale=0.05).requires_grad_(), randn((1536,), 9, scale=0.1).requires_grad_()
    w2, b2 = randn((192, 768), 10, scale=0.05).requires_grad_(), randn((192,), 11, scale=0.1).requires_grad_()
    cases.append(("geglu_ffn f32 (2, 600, 192)", torch.float32, ffn.geglu_ffn, ffn.geglu_ffn_plain, (x, w1, b1, w2, b2),
                  None))
    x, kw = randn((1, 3999, 512), 12).requires_grad_(), randn((3, 512, 512), 13, scale=0.03)
    packed = conv.pack_weight(kw).requires_grad_()
    cases.append(("strided_conv_gelu f32 K=3 T_in=3999", torch.float32, conv.strided_conv_gelu,
                  conv.strided_conv_gelu_plain, (x, packed), None))
    return cases


def phase_autograd():
    print("\n== phase 2b: the kernels' autograd wrappers on the card: forward against the plain twin, backward "
          "(PyTorch functions) against autograd through the plain twin ==")
    for label, dt, wrapper, plain, inputs, lengths in autograd_cases():
        got = wrapper(*inputs)
        want = plain(*inputs)
        check(got.grad_fn is not None, f"{label}: the wrapper's output has no grad_fn")
        g = randn(tuple(got.shape), 99, dt)
        if lengths is not None and label.startswith("flash"):
            # the kernel gives 0 at query rows past a length and its backward
            # follows the dense form there, as the JAX package's; the model's
            # gradient at padded rows is 0, so it is here
            g = g * (torch.arange(got.shape[1], device=DEV)[None, :, None]
                     < torch.tensor(lengths, device=DEV)[:, None, None]).to(dt)
        grads = torch.autograd.grad(got, inputs, g)
        ref = torch.autograd.grad(want, inputs, g)
        torch.cuda.synchronize()
        fwd = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        errs = [(a.float() - r.float()).abs().max().item() / r.float().abs().max().item() for a, r in zip(grads, ref)]
        bound = BOUND[dt]
        ok = fwd <= bound and max(errs) <= bound and all(np.isfinite(errs))
        print(f"{label:58s} forward {fwd:.3e}, backward {' '.join(f'{e:.3e}' for e in errs)} of max |plain| "
              f"(bound {bound:.0e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: wrapper against plain twin: forward {fwd:.3e}, backward {errs} > {bound}")


TRAIN_BOUND = {"loss": 1e-5, "grad": 1e-3, "global norm": 1e-4}


def train_inputs(batch, frames, window_real, seed):
    """Numpy inputs of one ``said_loss`` call: processed waveforms padded to
    the window, coefficients, CFG flags, timesteps and noise."""
    from said_tpu_torch.models.said import process_audio

    rng = np.random.default_rng(seed)
    wave_real = window_real * SR // FPS
    wave = process_audio(0.1 * rng.standard_normal((batch, wave_real)).astype(np.float32))
    wave = np.pad(wave, ((0, 0), (0, -(-frames * SR // FPS) - wave_real)))
    coeffs = rng.uniform(0, 1, (batch, frames, 32)).astype(np.float32)
    coeffs[:, window_real:] = 0.0
    noise = rng.standard_normal((batch, frames, 32)).astype(np.float32)
    return dict(waveform=wave, coeffs=coeffs, cond=np.array([True, False] * batch)[:batch],
                timesteps=rng.integers(0, 1000, batch), noise=noise), wave_real


def loss_and_grads(model, inputs, dev, bucketed, wave_real, window_real, cotangent=None):
    """``said_loss`` (deterministic, injected draws) on ``dev``: the loss,
    its gradients with respect to the trainable parameters, the
    prediction and the loss's gradient at it; with ``cotangent`` (a
    gradient at the prediction) also the parameters' gradients for it."""
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.train import said_train

    batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in inputs.items()}
    extra = dict(window_real=window_real, input_length=wave_real) if bucketed else {}
    captured = []
    hook = model.register_forward_hook(lambda module, args, out: captured.append(out))
    loss, _ = said_train.said_loss(model, DiffusionSchedule.create(1000), batch["waveform"], batch["coeffs"],
                                   batch["cond"], None, None, said_train.TrainConfig(), train=False,
                                   timesteps=batch["timesteps"], noise=batch["noise"], **extra)
    hook.remove()
    params = said_train.trainable_parameters(model)
    pred = captured[0]
    grads = torch.autograd.grad(loss, [pred, *params.values()], retain_graph=cotangent is not None)
    out = {"loss": loss.detach().cpu().double(), "grads": {n: g.detach().cpu() for n, g in zip(params, grads[1:])},
           "pred": pred.detach().cpu(), "dpred": grads[0].detach().cpu()}
    if cotangent is not None:
        shared = torch.autograd.grad(pred, list(params.values()), cotangent.to(dev))
        out["shared"] = {n: g.detach().cpu() for n, g in zip(params, shared)}
    return out


def compare_training(name, got, want, bounds):
    """Loss, per-tensor gradient (relative L2) and global-norm comparison;
    ``got`` and ``want`` are (loss, {name: gradient}). Returns whether
    every bound held."""
    loss_rel = abs((got[0] - want[0]) / want[0]).item()
    rels = {n: rel_l2(got[1][n], want[1][n]) for n in want[1] if want[1][n].norm() > 0}
    norm_got = torch.sqrt(sum((g.double() ** 2).sum() for g in got[1].values())).item()
    norm_want = torch.sqrt(sum((g.double() ** 2).sum() for g in want[1].values())).item()
    norm_rel = abs(norm_got - norm_want) / norm_want
    worst = max(rels, key=rels.get)
    ok = loss_rel <= bounds["loss"] and rels[worst] <= bounds["grad"] and norm_rel <= bounds["global norm"]
    print(f"{name}: loss {got[0].item():.6f} vs {want[0].item():.6f} (rel {loss_rel:.3e}, bound {bounds['loss']:.0e}); "
          f"gradient rel L2 max {rels[worst]:.3e} ({worst}), median {np.median(list(rels.values())):.3e} over "
          f"{len(rels)} tensors (bound {bounds['grad']:.2g}); global norm {norm_got:.6f} vs {norm_want:.6f} "
          f"(rel {norm_rel:.3e}, bound {bounds['global norm']:.2g}) {'ok' if ok else 'outside'}")
    check(len(rels) >= 0.9 * len(want[1]), f"{name}: most gradients are zero; the comparison would be vacuous")
    return ok


def sign_flips(card, cpu, noise, window_real):
    """The L1 terms' elements (prediction and velocity) whose sign differs
    between card and CPU, on the real frames, the largest |CPU residual|
    among them, and the smaller term's element count N: the loss's
    gradient is ±1/N there, so one such near-tie moves a gradient by 2/N,
    about 2/√N of its L2 norm."""
    def vel(x):
        return x[:, 1:] - x[:, :-1]

    flips, largest, count = 0, 0.0, card.numel()
    for r_card, r_cpu, n in ((card - noise, cpu - noise, window_real),
                             (vel(card) - vel(noise), vel(cpu) - vel(noise), window_real - 1)):
        flip = torch.sign(r_card[:, :n]) != torch.sign(r_cpu[:, :n])
        flips += int(flip.sum())
        count = min(count, flip.numel())
        if flip.any():
            largest = max(largest, r_cpu[:, :n][flip].abs().max().item())
    return flips, largest, count


def phase_train_card_vs_cpu(phase, batch, frames, window_real, flash):
    bucketed = window_real < frames
    print(f"\n== phase {phase}: full-width training loss and gradients, card (kernels) against CPU (plain twins): "
          f"batch {batch}, {frames}-frame window{f', {window_real} real (bucketed)' if bucketed else ''}, f32, "
          f"deterministic, injected timesteps and noise ==")
    configure_precision("float32")
    cpu_model = random_init_(build_said_model(), seed=0)
    card_model = copy.deepcopy(cpu_model).to(DEV)
    inputs, wave_real = train_inputs(batch, frames, window_real, seed=phase)
    t0 = time.perf_counter()
    cpu = loss_and_grads(cpu_model, inputs, torch.device("cpu"), bucketed, wave_real, window_real)
    print(f"cpu: loss and {len(cpu['grads'])} gradients in {time.perf_counter() - t0:.1f} s")
    zero_launches()
    t0 = time.perf_counter()
    card = loss_and_grads(card_model, inputs, DEV, bucketed, wave_real, window_real, cotangent=cpu["dpred"])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"card: loss and {len(card['grads'])} gradients in {time.perf_counter() - t0:.1f} s")
    print(f"launch counts in the card's loss and gradients: {launches}")
    used = ["group_norm_masked" if bucketed else "group_norm", "layer_norm", "geglu_ffn", "strided_conv_gelu"]
    check(all(launches[k] > 0 for k in used), f"a kernel of the training path was not launched: {launches}")
    check(launches["flash_attention"] == (4 + 12 if flash else 0),
          f"flash launches {launches['flash_attention']} != {4 + 12 if flash else 0}")
    pred_rel = ((card["pred"] - cpu["pred"]).abs().max() / cpu["pred"].abs().max()).item()
    flips, largest, count = sign_flips(card["pred"], cpu["pred"], torch.from_numpy(inputs["noise"]), window_real)
    print(f"prediction card vs CPU: max {pred_rel:.3e} of max |CPU|; L1 elements whose sign differs: {flips} "
          f"of {count} (largest |CPU residual| among them {largest:.3e})")
    # a flip (a near-tie of pred and answer) moves the loss's gradient at
    # the prediction by 2/N, about 2/√N of its norm: each widens the
    # natural gradients' bounds by that much (none: the stated bounds), the
    # backward through the kernels is held to the stated bounds on the
    # CPU's gradient at the prediction, and every flip must be a near-tie
    widen = flips * 2 / count ** 0.5
    natural = compare_training(f"{frames} frames card vs CPU, each its own loss gradient",
                               (card["loss"], card["grads"]), (cpu["loss"], cpu["grads"]),
                               {**TRAIN_BOUND, "grad": TRAIN_BOUND["grad"] + widen,
                                "global norm": TRAIN_BOUND["global norm"] + widen})
    shared = compare_training(f"{frames} frames card vs CPU, the CPU's loss gradient at the prediction on both",
                              (card["loss"], card["shared"]), (cpu["loss"], cpu["grads"]), TRAIN_BOUND)
    check(natural and shared and largest <= 1e-4,
          f"{frames} frames card vs CPU: gradients outside the bounds ({flips} sign flips, largest {largest:.3e})")
    return card_model


def phase_blockwise_backward(model):
    print("\n== phase 14b: a 4200-frame window on the card: the blockwise attention backward (1024-key blocks) "
          "against the dense-recompute one ==")
    inputs, wave_real = train_inputs(1, 4200, 4200, seed=15)
    calls = []
    blockwise = attention.chunked_attention_backward

    def spy(*args, block_k=None, **kwargs):
        calls.append(block_k)
        return blockwise(*args, block_k=block_k, **kwargs)

    attention.chunked_attention_backward = spy
    t0 = time.perf_counter()
    got = loss_and_grads(model, inputs, DEV, False, wave_real, 4200)
    torch.cuda.synchronize()
    t_block = time.perf_counter() - t0
    dense_max, attention.BWD_DENSE_MAX = attention.BWD_DENSE_MAX, 8192
    t0 = time.perf_counter()
    want = loss_and_grads(model, inputs, DEV, False, wave_real, 4200)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    attention.BWD_DENSE_MAX, attention.chunked_attention_backward = dense_max, blockwise
    print(f"attention backward calls {calls} (key blocks); loss and gradients in {t_block:.2f} s blockwise, "
          f"{t_dense:.2f} s dense recompute")
    check(calls == [attention.BWD_BLOCK_K] * 4 + [4200] * 4,
          f"attention backward blocks {calls}: not 4 blockwise then 4 dense (one a UNet self-attention)")
    check(torch.equal(got["pred"], want["pred"]), "the forward differs between the two backward routes")
    check(compare_training("4200 frames blockwise vs dense backward", (got["loss"], got["grads"]),
                           (want["loss"], want["grads"]), {"loss": 0.0, "grad": 1e-4, "global norm": 1e-4}),
          "4200 frames: the blockwise backward departs from the dense one")


def write_train_tree(root, train_clips, val_clips, seconds):
    """A synthetic BlendVOCA tree: ``train_clips`` sentences for each of 2
    train persons and ``val_clips`` for 1 val person, ``seconds`` long,
    random coefficients."""
    from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES, PERSON_IDS_TRAIN, PERSON_IDS_VAL
    from said_tpu_torch.utils.blendshape import save_blendshape_coeffs

    rng = np.random.default_rng(20)
    for persons, clips in ((PERSON_IDS_TRAIN[:2], train_clips), (PERSON_IDS_VAL[:1], val_clips)):
        for pid in persons:
            for sub in ("audio", "coeffs"):
                os.makedirs(os.path.join(root, sub, pid), exist_ok=True)
            for sid in range(1, clips + 1):
                write_wav(os.path.join(root, "audio", pid, f"sentence{sid:02}.wav"), seconds, seed=sid)
                save_blendshape_coeffs(rng.uniform(0, 1, (int(seconds * FPS), 32)).astype(np.float32),
                                       BLENDSHAPE_CLASSES, os.path.join(root, "coeffs", pid, f"sentence{sid:02}.csv"))
    return os.path.join(root, "audio"), os.path.join(root, "coeffs")


def train_run(label, argv, gpu_line):
    """One run of the training CLI on the card; the launch counters are
    zeroed just before the run and read just after."""
    from said_tpu_torch.cli import train as train_cli

    zero_launches()
    t0 = time.perf_counter()
    train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"{label}: wall {wall:.2f} s (model build + random init + data + steps + validation + checkpoints) on "
          f"{gpu_line}; launch counts in the run: {launches}")
    return launches


def check_train_launches(label, launches, steps, val_batches):
    """Exact launch counts of ``steps`` train steps and ``val_batches``
    validation calls, each one forward of the model: the encoder's 6
    convs and its conv_0 GroupNorm, the UNet's 15 GroupNorms (every one
    masked: windows are bucketed); validation runs the fused GEGLU (4 a
    forward), training the unfused one; LayerNorms: the UNet's 12, the
    encoder's 2 + 2 a layer that layerdrop keeps (train mode: 2 to 26)."""
    calls = steps + val_batches
    want = {"group_norm": 0, "group_norm_masked": 16 * calls, "geglu_ffn": 4 * val_batches,
            "strided_conv_gelu": 6 * calls, "flash_attention": 0}
    check(all(launches[k] == n for k, n in want.items()), f"{label}: launch counts {launches}, expected {want} and "
          f"LayerNorm between {14 * calls} and {38 * calls}")
    check(14 * calls <= launches["layer_norm"] <= 38 * calls, f"{label}: LayerNorm launches {launches['layer_norm']}")


def phase_train_cli(gpu_line):
    print("\n== phase 15: the training CLI at full width on a synthetic tree (2 train persons x 8 sentences and 1 val "
          "person x 2 sentences of 5 s; batch 8, default windows and buckets): 4 epochs f32, resume, 3 epochs bf16 ==")
    root = os.path.join(WORK, "train_tree")
    audio_dir, coeffs_dir = write_train_tree(root, train_clips=8, val_clips=2, seconds=5.0)
    out_dir, bf16_dir = os.path.join(WORK, "train_out"), os.path.join(WORK, "train_out_bf16")
    for d in (out_dir, bf16_dir):  # the CLI appends to metrics.jsonl: start from none
        shutil.rmtree(d, ignore_errors=True)
    common = ["--device", "cuda", "--audio_dir", audio_dir, "--coeffs_dir", coeffs_dir, "--batch_size", "8",
              "--seed", "0", "--val_repeat", "1"]
    # 16 clips in batches of 8: 2 steps an epoch; validation once over 2 clips
    launches = train_run("f32, 4 epochs", common + [
        "--output_dir", out_dir, "--dtype", "float32", "--epochs", "4", "--save_period", "2", "--val_period", "4"],
        gpu_line)
    check_train_launches("f32, 4 epochs", launches, steps=2 * 4, val_batches=2)
    launches = train_run("f32, resume from epoch 2, 1 epoch", common + [
        "--output_dir", out_dir, "--dtype", "float32", "--epochs", "1", "--val_period", "1000", "--save_period", "1000",
        "--export_pth", "", "--resume", os.path.join(out_dir, "ckpt", "2")], gpu_line)
    check_train_launches("f32, resume", launches, steps=2, val_batches=0)
    launches = train_run("bf16, 3 epochs", common + [
        "--output_dir", bf16_dir, "--dtype", "bfloat16", "--epochs", "3", "--val_period", "1000", "--save_period",
        "1000"], gpu_line)
    check_train_launches("bf16, 3 epochs", launches, steps=2 * 3, val_batches=0)
    # no validation and no checkpoint in this run: its counts are train steps' alone
    per_step = {k: n / (2 * 3) for k, n in launches.items()}
    print(f"launches per train step (bf16 run; forward: the backward launches no kernel): {per_step}")

    with open(os.path.join(out_dir, "SAiD", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    with open(os.path.join(bf16_dir, "SAiD", "metrics.jsonl")) as f:
        bf16_lines = [json.loads(line) for line in f]
    print("metrics:", [{k: round(v, 5) for k, v in line.items() if k in ("step", "Train/loss", "Validation/loss")}
                       for line in lines + bf16_lines])
    check([line["step"] for line in lines] == [1, 2, 3, 4, 1] and len(bf16_lines) == 3,
          f"metrics lines: {[line['step'] for line in lines]}, bf16 {len(bf16_lines)}")
    check(all(np.isfinite(line["Train/loss"]) and line["Train/nan_skipped"] == 0.0 for line in lines + bf16_lines),
          "a train loss is not finite or a step was skipped")
    check("Validation/loss" in lines[3] and np.isfinite(lines[3]["Validation/loss"]), "no validation at epoch 4")
    for epoch in (2, 4):
        check(os.path.isfile(os.path.join(out_dir, "ckpt", str(epoch), "train_state.pt"))
              and os.path.isfile(os.path.join(out_dir, f"{epoch}.pth")), f"epoch {epoch}: no checkpoint or .pth")
    wav, csv_path = os.path.join(WORK, "train_check.wav"), os.path.join(WORK, "train_check.csv")
    write_wav(wav, 2.0, seed=30)
    cli.main(["--device", "cuda", "--num_steps", "20", "--weights_path", os.path.join(out_dir, "4.pth"),
              "--audio_path", wav, "--output_path", csv_path])
    header, coeffs = read_csv(csv_path)
    print(f"4.pth through the inference CLI (strict load): CSV {coeffs.shape}, min {coeffs.min():.4f} "
          f"max {coeffs.max():.4f}")
    check(tuple(header) == ARKIT_BLENDSHAPES and coeffs.shape == (120, 32) and np.isfinite(coeffs).all()
          and coeffs.min() >= 0.0 and coeffs.max() <= 1.0, "the exported .pth did not generate a valid CSV")
    # the train step's time, as profile_train reads it: one fixed batch
    # (8 rows of 300 frames bucketed to 304), after 3 warm-up steps
    from said_tpu_torch import profile_train
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule

    configure_precision("float32")
    batch, schedule = profile_train.make_batch(DEV), DiffusionSchedule.create(1000)
    step_ms = {}
    for dtype in ("float32", "bfloat16"):
        cell = profile_train.make_cell(dtype, DEV)
        profile_train.run_steps(cell, schedule, batch, 3)
        reads = [profile_train.step_ms(cell, schedule, batch, 10) for _ in range(3)]
        step_ms[dtype] = float(np.median(reads))
        print(f"{dtype} train step (host, synchronised; profile_train's batch: 8 x 304 frames, 300 real) median "
              f"{step_ms[dtype]:.2f} ms of 3 x 10 steps [{' '.join(f'{t:.2f}' for t in reads)}] on {gpu_line}")
        del cell
    print(json.dumps({"training": {"device": gpu_line, "batch": 8, "f32_train_step_ms": step_ms["float32"],
                                    "bf16_train_step_ms": step_ms["bfloat16"], "launches_per_step": per_step}}))


# ------------------------------------------------------------ streaming


def phase_streaming_cli(record, gpu_line, whole_clip_wall):
    """The 6-min clip of phase 8 (same WAV) as 60-s windows with a 6-s
    pinned overlap: 7 windows, each one pipeline call of 3600 frames (the
    flash path) with its own prepare, so the counts are 7 × one call's;
    the editing path adds no launch (its mask and re-noising are
    elementwise)."""
    starts = streaming_starts(21600, 3600, 360)
    check(starts == [0, 3240, 6480, 9720, 12960, 16200, 18000], f"window starts {starts}")
    expected = expected_launches(25, calls=len(starts))
    wall = cli_request(record, gpu_line, 16, 360.0, 25, ["--solver", "dpmpp_2m", "--streaming_window", "3600",
                                                         "--streaming_overlap", "360"], expected, seed=3)
    # phase 8 was the process's first 6-min request (the allocator grew to
    # its sizes there): the whole clip again, warm, for a like comparison
    warm = cli_request(record, gpu_line, "16b", 360.0, 25, ["--solver", "dpmpp_2m"], expected_launches(25), seed=3)
    print(f"6-min request: streaming ({len(starts)} windows at {starts}) {wall:.2f} s against the whole clip "
          f"{warm:.2f} s warm (phase 8, the first: {whole_clip_wall:.2f} s) on {gpu_line}")
    # the pipeline alone (no model build, audio or CSV), warm, in turns
    # (whole, streaming, streaming, whole): host ms, then one profiled run
    # each for the card's busy time (profile_step's timer and profiler)
    from said_tpu_torch import profile_step

    configure_precision("float32")
    pipe = SAIDPipeline(random_init_(build_said_model(), seed=0).to(DEV).eval())
    wave = process_audio(0.1 * np.random.default_rng(12).standard_normal(360 * SR).astype(np.float32))
    kw = dict(num_inference_steps=25, guidance_scale=2.0, solver="dpmpp_2m",
              generator=torch.Generator(device=DEV).manual_seed(0))
    runs = {"whole clip": lambda: pipe.inference(wave, **kw),
            "streaming": lambda: pipe.inference_streaming(wave, window_frames=3600, overlap_frames=360, **kw)}
    for fn in runs.values():  # warm-up
        fn()
    host = {name: [] for name in runs}
    for name in ("whole clip", "streaming", "streaming", "whole clip"):
        host[name].append(profile_step.host_ms(runs[name]))
    pipeline = {}
    for name, fn in runs.items():
        prof = profile_step.device_profile(fn)
        ms = float(np.median(host[name]))
        busy = prof["device_busy_ms"]
        pipeline[name] = {"host_ms": ms, "host_ms_runs": host[name], "device_busy_ms": busy,
                          "idle_share": None if busy is None else 1.0 - busy / ms, "launches": prof["launches"],
                          "by_family_ms": prof["by_family_ms"]}
        top = "" if busy is None else ", ".join(f"{k} {v:.1f}" for k, v in list(prof["by_family_ms"].items())[:4])
        print(f"pipeline {name}: host {ms:.1f} ms [{' '.join(f'{t:.1f}' for t in host[name])}], device busy "
              f"{'not measured' if busy is None else f'{busy:.1f} ms, idle share {1.0 - busy / ms:.2f}'}; {top}")
    print(json.dumps({"streaming": {"device": gpu_line, "windows": len(starts), "streaming_wall_s": wall,
                                    "whole_clip_wall_s": warm, "whole_clip_first_wall_s": whole_clip_wall,
                                    "pipeline": pipeline}}))


def phase_streaming_card_vs_cpu():
    print("\n== phase 17: streaming, card against CPU: 20-s clip (1200 frames), 600-frame windows, overlap 120 "
          "(windows at 0, 480, 600), 10 DDIM steps, CFG 2.0, injected per-window noise ==")
    configure_precision("float32")
    cpu_model = random_init_(build_said_model(), seed=0).eval()
    card = SAIDPipeline(copy.deepcopy(cpu_model).to(DEV))
    rng = np.random.default_rng(8)
    wave = process_audio(0.1 * rng.standard_normal(20 * SR).astype(np.float32))
    starts = streaming_starts(1200, 600, 120)
    check(starts == [0, 480, 600], f"window starts {starts}")
    noise = [{("latents" if k == 0 else "edit_noise"): rng.standard_normal((1, 600, 32)).astype(np.float32)}
             for k in range(len(starts))]
    kw = dict(window_frames=600, overlap_frames=120, num_inference_steps=10, guidance_scale=2.0, window_noise=noise)
    calls, inference = [], card.inference

    def spy(wave_k, **kwargs):
        res = inference(wave_k, **kwargs)
        calls.append((kwargs.get("init_samples"), kwargs.get("mask"), res.result))
        return res

    card.inference = spy
    t0 = time.perf_counter()
    res_card = card.inference_streaming(wave, **kw).result
    t_card = time.perf_counter() - t0
    card.inference = inference
    t0 = time.perf_counter()
    res_cpu = SAIDPipeline(cpu_model).inference_streaming(wave, **kw).result
    t_cpu = time.perf_counter() - t0
    with torch.no_grad():
        wave_t = torch.from_numpy(wave[:, : 600 * SR // FPS]).to(DEV)
        kv, table = card.prepare(wave_t, 600, True)
        eps = card.model.unet(torch.from_numpy(noise[0]["latents"]).to(DEV), kv_caches=kv, emb=table[999],
                              cfg_fold=True)
    eps_std = eps.std().item()
    diff = np.abs(res_card - res_cpu)
    print(f"stitched {res_card.shape}: coefficient MAE {diff.mean():.3e} (bound 1e-4) max {diff.max():.3e} "
          f"(bound 1e-3), denoiser output std {eps_std:.4f} (must be > 1e-3); card {t_card:.1f} s, cpu {t_cpu:.1f} s")
    check(res_card.shape == res_cpu.shape == (1, 1200, 32), f"shapes {res_card.shape} / {res_cpu.shape}")
    check(np.isfinite(res_card).all() and res_card.min() >= 0.0 and res_card.max() <= 1.0, "not finite in [0, 1]")
    check(eps_std > 1e-3, "denoiser output is degenerate; the comparison would be vacuous")
    check(diff.mean() <= 1e-4 and diff.max() <= 1e-3, f"card vs CPU MAE {diff.mean():.3e} / max {diff.max():.3e}")
    check(len(calls) == 3 and calls[0][0] is None, f"{len(calls)} window calls")
    for k, (init, mask, res) in enumerate(calls[1:], start=1):
        kept = int(mask[0, :, 0].sum())
        check(np.array_equal(res[:, :kept], init[:, :kept]), f"window {k}: the pinned rows moved")
        print(f"window {k}: {kept} pinned rows equal their init bit for bit on the card")


def phase_layer_feature_norm():
    print('\n== phase 18: a "layer" feature extractor (conv bias, LayerNorm after every conv; base widths, '
          "2 transformer layers), card against CPU, 4-s clip ==")
    from said_tpu_torch.models.said import SAID
    from said_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    configure_precision("float32")
    cpu_model = random_init_(SAID(audio_config=Wav2Vec2Config(feat_extract_norm="layer", conv_bias=True,
                                                              num_hidden_layers=2)), seed=0).eval()
    rng = np.random.default_rng(9)
    with torch.no_grad():  # random_init_ leaves biases 0 and norm scales 1: draw them
        for layer in cpu_model.audio_encoder.feature_extractor.conv_layers:
            for p in (layer.conv.bias, layer.layer_norm.weight, layer.layer_norm.bias):
                p.copy_(torch.from_numpy((rng.standard_normal(p.shape) * 0.3).astype(np.float32)) + (p == 1).float())
    card_model = copy.deepcopy(cpu_model).to(DEV)
    wave = process_audio(0.1 * rng.standard_normal(4 * SR).astype(np.float32))
    zero_launches()
    with torch.no_grad():
        got = card_model.get_audio_embedding(torch.from_numpy(wave).to(DEV), 240).cpu()
        torch.cuda.synchronize()
        launches = read_launches()
        want = cpu_model.get_audio_embedding(torch.from_numpy(wave), 240)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    # 7 conv layers' LayerNorms, the feature projection's, the encoder's and 2 a layer
    expected = {name: 0 for name in KERNELS} | {"layer_norm": 7 + 2 + 2 * 2}
    print(f"embedding {tuple(got.shape)}: max |card - CPU| {rel:.3e} of max |CPU| (bound {LONG_BOUND:.0e}), "
          f"std {want.std().item():.4f}; launches {launches}")
    check(launches == expected, f"launch counts {launches} != {expected}")
    check(want.std().item() > 1e-3 and np.isfinite(rel) and rel <= LONG_BOUND, f"layer encoder card vs CPU {rel:.3e}")


# ------------------------------------------------------------ the BCVAE stack


def phase_vae_train_step():
    print("\n== phase 19: one BCVAE train step (ELBO, train-mode BatchNorm), card against CPU: batch 32 of 120x32 "
          "windows, injected eps, f32, TF32 off ==")
    from said_tpu_torch.cli._common import load_vae
    from said_tpu_torch.models.vae import BATCHNORM_CANCELLED_BIASES
    from said_tpu_torch.train import vae_train

    configure_precision("float32")
    rng = np.random.default_rng(11)
    coeffs = rng.uniform(0, 1, (32, 120, 32)).astype(np.float32)
    eps = rng.standard_normal((32, 64)).astype(np.float32)
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
        model = load_vae("", seed=0, device=dev)
        state = vae_train.VAETrainState(model, vae_train.VAETrainConfig())
        t0 = time.perf_counter()
        loss, _ = vae_train.elbo_loss(model, torch.from_numpy(coeffs).to(dev), None, state.config, 0.5,
                                      train=True, eps=torch.from_numpy(eps).to(dev))
        grads = torch.autograd.grad(loss, list(state.params.values()))
        state.optimizer.update(grads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = {"loss": loss.item(), "grads": {n: g.cpu() for n, g in zip(state.params, grads)},
                     "stats": {n: b.cpu() for n, b in model.named_buffers() if n.endswith(("mean", "var"))}, "ms": ms}
    cpu, card = out["cpu"], out["card"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in cpu["grads"].values())).item()
    grad_rel, zero_abs = {}, 0.0
    for n, want in cpu["grads"].items():
        if n in BATCHNORM_CANCELLED_BIASES:  # exactly 0: rounding noise on both sides
            zero_abs = max(zero_abs, card["grads"][n].abs().max().item() / norm, want.abs().max().item() / norm)
        else:
            grad_rel[n] = rel_l2(card["grads"][n], want)
    stats_rel = max(((card["stats"][n] - w).abs().max() / w.abs().max()).item() for n, w in cpu["stats"].items())
    worst = max(grad_rel, key=grad_rel.get)
    print(f"loss {cpu['loss']:.6f}: card vs CPU {loss_rel:.3e} (bound {VAE_BOUND['loss']:.0e}); gradients: max "
          f"{grad_rel[worst]:.3e} relative L2 ({worst}; bound {VAE_BOUND['grad']:.0e}), median "
          f"{np.median(list(grad_rel.values())):.3e}; the BatchNorm-cancelled biases' at most {zero_abs:.1e} of the "
          f"global norm; running statistics {stats_rel:.3e} (bound {VAE_BOUND['stats']:.0e}); step (forward, "
          f"backward, update; first call) card {card['ms']:.1f} ms, cpu {cpu['ms']:.1f} ms")
    check(np.isfinite(loss_rel) and loss_rel <= VAE_BOUND["loss"], f"VAE loss card vs CPU {loss_rel:.3e}")
    check(all(np.isfinite(v) and v <= VAE_BOUND["grad"] for v in grad_rel.values()), f"VAE gradient {worst} "
          f"card vs CPU {grad_rel[worst]:.3e}")
    check(zero_abs <= 1e-6, f"a BatchNorm-cancelled bias has a gradient of {zero_abs:.1e} of the global norm")
    check(np.isfinite(stats_rel) and stats_rel <= VAE_BOUND["stats"], f"VAE running stats card vs CPU {stats_rel:.3e}")


def write_coeff_tree(root, persons, sentences, frames, repeats=0, noise_of=None, seed=21):
    """CSVs ``<root>/<person>/sentenceXX.csv`` (or ``sentenceXX-k.csv``
    for k < ``repeats``): smooth random coefficients, or, with
    ``noise_of``, that tree's CSVs plus noise."""
    from said_tpu_torch.data.blendvoca import BLENDSHAPE_CLASSES
    from said_tpu_torch.utils.blendshape import load_blendshape_coeffs, save_blendshape_coeffs

    rng = np.random.default_rng(seed)
    for pid in persons:
        os.makedirs(os.path.join(root, pid), exist_ok=True)
        for sid in range(1, sentences + 1):
            name = f"sentence{sid:02}"
            if noise_of is None:
                base = np.clip(0.5 + np.cumsum(rng.standard_normal((frames, 32)), axis=0) * 0.02, 0, 1)
            else:
                base = load_blendshape_coeffs(os.path.join(noise_of, pid, name + ".csv"))
            for suffix in ([f"-{k}" for k in range(repeats)] if repeats else [""]):
                coeffs = base if noise_of is None else np.clip(base + rng.standard_normal(base.shape) * 0.05, 0, 1)
                save_blendshape_coeffs(coeffs.astype(np.float32), BLENDSHAPE_CLASSES,
                                       os.path.join(root, pid, name + suffix + ".csv"))


def phase_vae_clis(gpu_line):
    print("\n== phase 20: train_vae (2 train persons x 8 sentences, 1 val person; 3 epochs) -> inference_vae -> "
          "test_evaluate (2 test persons x 4 sentences x 4 repeats of 300 frames, generated = real + noise) ==")
    from said_tpu_torch.cli import inference_vae, test_evaluate, train_vae
    from said_tpu_torch.cli._common import load_vae
    from said_tpu_torch.core.checkpoint import STATE_FILE, save_pth
    from said_tpu_torch.data.blendvoca import PERSON_IDS_TRAIN, PERSON_IDS_VAL, BlendVOCAEvalDataset
    from said_tpu_torch.eval import metrics

    root = os.path.join(WORK, "vae")
    shutil.rmtree(root, ignore_errors=True)  # train_vae appends to metrics.jsonl
    coeffs_dir, out_dir = os.path.join(root, "coeffs"), os.path.join(root, "out")
    write_coeff_tree(coeffs_dir, PERSON_IDS_TRAIN[:2], 8, 300)
    write_coeff_tree(coeffs_dir, PERSON_IDS_VAL[:1], 2, 300, seed=22)
    walls = {}
    t0 = time.perf_counter()
    train_vae.main(["--device", DEV.type, "--coeffs_dir", coeffs_dir, "--output_dir", out_dir, "--epochs", "3",
                    "--val_period", "1", "--val_repeat", "1", "--save_period", "3"])
    torch.cuda.synchronize()
    walls["train_vae"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "SAiD-VAE", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    print("metrics:", [{k: round(v, 4) for k, v in line.items() if k in ("step", "Train/loss", "Validation/loss")}
                       for line in lines])
    check([line["step"] for line in lines] == [1, 2, 3] and all("Validation/loss" in line for line in lines)
          and all(np.isfinite(v) for line in lines for v in line.values()), "train_vae metrics lines")
    ckpt = os.path.join(out_dir, "ckpt", "3", STATE_FILE)
    check(os.path.isfile(ckpt), "train_vae wrote no checkpoint at epoch 3")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    vae_pth = os.path.join(root, "vae.pth")
    save_pth(saved["model"] | saved["ema"], vae_pth)  # the EMA weights with the running statistics

    t0 = time.perf_counter()
    recon = inference_vae.main(["--device", DEV.type, "--weights_path", vae_pth, "--blendshape_coeffs_path",
                                os.path.join(coeffs_dir, PERSON_IDS_TRAIN[0], "sentence01.csv"),
                                "--output_path", os.path.join(root, "recon.csv")])
    walls["inference_vae"] = time.perf_counter() - t0
    header, csv_coeffs = read_csv(os.path.join(root, "recon.csv"))
    check(tuple(header) == ARKIT_BLENDSHAPES and csv_coeffs.shape == (120, 32) and np.isfinite(csv_coeffs).all()
          and csv_coeffs.min() >= 0.0 and csv_coeffs.max() <= 1.0 and recon.shape == (120, 32),
          f"inference_vae CSV {csv_coeffs.shape}")

    split = os.path.join(root, "split")
    for pid in PERSON_IDS_TEST:
        os.makedirs(os.path.join(split, "audio", pid), exist_ok=True)
        for sid in range(1, 5):
            write_wav(os.path.join(split, "audio", pid, f"sentence{sid:02}.wav"), 5.0, seed=40 + sid)
    real_dir, gen_dir = os.path.join(split, "real"), os.path.join(split, "gen")
    write_coeff_tree(real_dir, PERSON_IDS_TEST, 4, 300, seed=23)
    write_coeff_tree(gen_dir, PERSON_IDS_TEST, 4, 300, repeats=4, noise_of=real_dir, seed=24)
    t0 = time.perf_counter()
    result = test_evaluate.main(["--device", DEV.type, "--audio_dir", os.path.join(split, "audio"), "--coeffs_dir",
                                 gen_dir, "--coeffs_real_dir", real_dir, "--vae_weights_path", vae_pth])
    torch.cuda.synchronize()
    walls["test_evaluate"] = time.perf_counter() - t0
    fd, mm, wind = result["frechet_distance"], result["multimodality"], result["wind"]
    check(all(np.isfinite(v) and v >= 0 for v in (fd, mm, wind["mean"], wind["std"])), f"test_evaluate {result}")

    # its parts apart: encoding the generated set's windows, one mixture fit
    model = load_vae(vae_pth, device=DEV)
    gen = BlendVOCAEvalDataset(os.path.join(split, "audio"), gen_dir)
    real = BlendVOCAEvalDataset(os.path.join(split, "audio"), real_dir)
    t0 = time.perf_counter()
    gen_infos = test_evaluate.generate_latents_info(model, gen, 1)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    latents = [i.latent for i in gen_infos]
    t0 = time.perf_counter()
    metrics.get_statistic_gmm(latents, 5, torch.Generator(device=DEV).manual_seed(0), DEV)
    gmm_s = time.perf_counter() - t0
    rs = metrics.get_statistic([i.latent for i in test_evaluate.generate_latents_info(model, real, 1, padding=2)])
    self_fd = metrics.frechet_distance(rs.mean, rs.cov, rs.mean, rs.cov)
    trace = float(np.trace(rs.cov))
    print(f"test_evaluate: {result}")
    print(f"FD of the real set against itself {self_fd:.3e} (bound 1e-6 x trace {trace:.3e})")
    check(abs(self_fd) <= 1e-6 * trace, f"FD of the real set against itself {self_fd:.3e}")
    print(f"wall: train_vae (3 epochs) {walls['train_vae']:.2f} s, inference_vae {walls['inference_vae']:.2f} s, "
          f"test_evaluate {walls['test_evaluate']:.2f} s (10 x 2 mixture fits); encoding {len(latents)} generated "
          f"windows {encode_s:.3f} s, one 5-component fit to them {gmm_s:.3f} s; on {gpu_line}")
    print(json.dumps({"evaluation": {"device": gpu_line, **{f"{k}_wall_s": v for k, v in walls.items()},
                                     "encode_s": encode_s, "encoded_windows": len(latents), "gmm_fit_s": gmm_s,
                                     "metrics": result}}))


# ------------------------------------------------------------ the asset pipeline

# the pseudo-GT QP: the f32 ADMM on the card against the native f64 solver
# and against the same ADMM on the CPU (max abs); the box and the
# smoothness bound; the CLI's CSVs against the weights the meshes were made
# from (no constraint active)
QP_BOUND = 1e-4
QP_BOX, QP_SMOOTH, QP_RECOVER = 1e-6, 1e-5, 5e-3
FLAME_VERTICES, SEQ_FRAMES, DELTA = 5023, 120, 0.1


def flame_like_template(seed):
    """A 5023-vertex (FLAME's count) front-facing surface with a bump: the
    first 5023 vertices of a 69 x 73 grid over 0.3 m, faces over the grid's
    whole quads."""
    from said_tpu_torch.utils.mesh import create_mesh

    rows, cols = 69, 73
    x, y = np.meshgrid(np.linspace(-0.15, 0.15, cols), np.linspace(0.16, -0.16, rows))
    z = 0.05 * np.exp(-(x**2 + y**2) / 0.01) + 0.001 * np.random.default_rng(seed).standard_normal(x.shape)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)[:FLAME_VERTICES]
    i = (np.arange(rows - 1)[:, None] * cols + np.arange(cols - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([i, i + 1, i + cols], 1), np.stack([i + 1, i + cols + 1, i + cols], 1)])
    return create_mesh(verts, faces[(faces < FLAME_VERTICES).all(axis=1)])


def blendshape_bumps(head, seed):
    """32 smooth deltas on the head vertices: a Gaussian bump each (5 mm,
    sigma 1.5 cm) along a random direction, centred on a jittered 8 x 4
    grid over the face, so that the Gram matrix is well conditioned."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-0.12, 0.12, 8), np.linspace(-0.12, 0.12, 4))
    centres = np.stack([gx.ravel(), gy.ravel()], axis=1) + rng.uniform(-0.005, 0.005, (32, 2))
    out = {}
    for name, centre in zip(ARKIT_BLENDSHAPES, centres):
        direction = rng.standard_normal(3)
        weight = np.exp(-((head[:, :2] - centre) ** 2).sum(axis=1) / (2 * 0.015**2))
        out[name] = 0.005 * weight[:, None] * direction / np.linalg.norm(direction)
    return out


def smooth_weights(frames, seed, amplitude=0.3):
    """(frames, 32) sinusoids about 0.5, 0.5 to 2 periods over 120 frames:
    at most 0.032 a frame apart at amplitude 0.3."""
    rng = np.random.default_rng(seed)
    f, phase = rng.uniform(0.5, 2.0, 32), rng.uniform(0, 2 * np.pi, 32)
    return 0.5 + amplitude * np.sin(2 * np.pi * np.outer(np.arange(frames), f) / SEQ_FRAMES + phase)


def timed_call(fn):
    """(result, wall s) of one call, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def admm_launches(gram, q, pairs=3, tries=12):
    """Kernel launches and device µs an ADMM iteration on the card, from
    two runs under ``torch.profiler`` (CUDA activity) that never stop early
    (tol < 0) and never read the stop flag: 16 and 48 iterations, so the
    set-up and the result's copy cancel. Copies, memsets and the
    profiler's own buffer events are not launches. The median of
    ``pairs`` whole pairs. A pair is whole when every kernel's count in
    the 48-iteration record exceeds its count in the 16-iteration record
    by a multiple of 32 (0 included): both runs make the same set-up
    launches, so a record that lacks some of them was torn by the
    profiler, not by the ADMM (one H100 run read 10 pairs at T=240 of
    which one had 5-7 fewer of each set-up kernel in its 48-iteration
    record, 1317 launches where the others read 1376 = 43 x 32). Torn
    pairs are read again, up to ``tries`` times; an ADMM whose launches
    vary between iterations tears every pair and fails."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from said_tpu_torch.optimize.qp import admm_sequence_qp

    def record(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            admm_sequence_qp(gram, q, DELTA, max_iters=n, tol=-1.0, device=DEV, check_every=10**6)
            torch.cuda.synchronize()
        counts, busy = collections.Counter(), 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and not e.name.startswith(("Memcpy", "Memset", "Activity Buffer")):
                counts[e.name] += 1
                busy += e.time_range.elapsed_us()
        return counts, busy

    record(16)  # the caching allocator's blocks for this T
    reads, torn = [], 0
    while len(reads) < pairs and torn < tries:
        (few, few_us), (many, many_us) = record(16), record(48)
        extra = {name: many[name] - few[name] for name in few.keys() | many.keys()}
        if any(n < 0 or n % 32 for n in extra.values()):
            torn += 1
            print(f"ADMM launch record torn, read again: kernels whose 48 - 16 iteration counts are no multiple "
                  f"of 32: {sorted((k[:40], n) for k, n in extra.items() if n < 0 or n % 32)}")
            continue
        reads.append((sum(extra.values()) / 32, (many_us - few_us) / 32))
    check(len(reads) == pairs, f"ADMM launches an iteration: {torn} torn records, {len(reads)} of {pairs} whole pairs")
    if len({launches for launches, _ in reads}) > 1:
        print(f"ADMM launches an iteration, pair by pair: {[launches for launches, _ in reads]}")
    return float(np.median([r[0] for r in reads])), float(np.median([r[1] for r in reads]))


def phase_pseudo_gt(gpu_line):
    print(f"\n== phase 21: pseudo-GT at BlendVOCA's sizes: preprocess_blendvoca (2 persons' {FLAME_VERTICES}-vertex "
          f"templates cropped to the FLAME head) -> optimize_blendshape_coeffs (1 sentence a person, {SEQ_FRAMES} "
          f"binary PLY frames, delta {DELTA}); the QP at N=32 and 13740 coordinates, T=240 and 3600: native, the "
          f"ADMM on the card, the ADMM on the CPU ==")
    import pickle

    from said_tpu_torch.cli import optimize_blendshape_coeffs, preprocess_blendvoca
    from said_tpu_torch.data.assets import asset_path
    from said_tpu_torch.optimize.qp import solve_sequence_qp
    from said_tpu_torch.utils.blendshape import load_blendshape_coeffs
    from said_tpu_torch.utils.mesh import create_mesh, save_mesh
    from said_tpu_torch.utils.parser import parse_list

    root = os.path.join(WORK, "pseudo_gt")
    shutil.rmtree(root, ignore_errors=True)
    head_idx = np.asarray(parse_list(asset_path("FLAME_head_idx.txt"), int))
    templates, deltas, weights = {}, {}, {}
    os.makedirs(os.path.join(root, "templates"))
    t0 = time.perf_counter()
    for k, pid in enumerate(PERSON_IDS_TEST):
        templates[pid] = flame_like_template(seed=k)
        save_mesh(templates[pid], os.path.join(root, "templates", f"{pid}.ply"))
        deltas[pid] = blendshape_bumps(templates[pid].vertices[head_idx], seed=10 + k)
        weights[pid] = smooth_weights(SEQ_FRAMES, seed=20 + k)
        basis = np.stack([deltas[pid][n] for n in ARKIT_BLENDSHAPES], axis=-1)  # (V_head, 3, 32)
        seq_dir = os.path.join(root, "seqs", pid, "sentence01")
        os.makedirs(seq_dir)
        noise = np.random.default_rng(30 + k)
        for t in range(SEQ_FRAMES):
            verts = templates[pid].vertices.copy()
            verts[head_idx] += basis @ weights[pid][t] + 1e-5 * noise.standard_normal((len(head_idx), 3))
            save_mesh(create_mesh(verts, templates[pid].faces), os.path.join(seq_dir, f"{t:05}.ply"))
    with open(os.path.join(root, "deltas.pickle"), "wb") as f:
        pickle.dump(deltas, f)
    walls = {"write_tree": time.perf_counter() - t0}

    blend = os.path.join(root, "BlendVOCA")
    t0 = time.perf_counter()
    done = preprocess_blendvoca.main(["--templates_dir", os.path.join(root, "templates"), "--blendshape_residuals_path",
                                      os.path.join(root, "deltas.pickle"), "--blendshapes_out_dir", blend])
    walls["preprocess_blendvoca"] = time.perf_counter() - t0
    check(done == PERSON_IDS_TEST, f"preprocess processed {done}")
    t0 = time.perf_counter()
    solutions = optimize_blendshape_coeffs.main([
        "--neutrals_dir", os.path.join(blend, "templates_head"), "--blendshapes_dir",
        os.path.join(blend, "blendshapes_head"), "--mesh_seqs_dir", os.path.join(root, "seqs"),
        "--blendshapes_coeffs_out_dir", os.path.join(root, "coeffs"), "--delta", str(DELTA)])
    walls["optimize_blendshape_coeffs"] = time.perf_counter() - t0
    check(sorted(solutions) == [(pid, 1) for pid in PERSON_IDS_TEST]
          and all(s.solver == "native" for s in solutions.values()), f"optimize solutions {solutions.keys()}")
    for pid in PERSON_IDS_TEST:
        got = load_blendshape_coeffs(os.path.join(root, "coeffs", pid, "sentence01.csv"))
        err = np.abs(got - weights[pid]).max()
        print(f"{pid}: CSV {got.shape}, native solver {solutions[pid, 1].iterations} iterations, max |w - known| "
              f"{err:.2e} (bound {QP_RECOVER:.0e})")
        check(got.shape == (SEQ_FRAMES, 32) and err <= QP_RECOVER, f"{pid}: pseudo-GT off the known weights by {err}")
    print(f"wall: synthetic tree {walls['write_tree']:.2f} s ({2 * SEQ_FRAMES} PLY frames), preprocess_blendvoca "
          f"{walls['preprocess_blendvoca']:.2f} s ({2 * 33} OBJ), optimize_blendshape_coeffs "
          f"{walls['optimize_blendshape_coeffs']:.2f} s (66 OBJ + {2 * SEQ_FRAMES} PLY read, 2 QPs) on {gpu_line}")

    # the QP alone at the head's 13740 coordinates: box and smoothness active
    basis = np.stack([deltas[PERSON_IDS_TEST[0]][n].reshape(-1) for n in ARKIT_BLENDSHAPES], axis=1)
    gram = basis.T @ basis
    rng = np.random.default_rng(40)
    solve_sequence_qp(gram, rng.standard_normal((24, 32)), DELTA, backend="torch", device=DEV)  # CUDA libraries
    qp_record = {"device": gpu_line, "coordinates": basis.shape[0]}
    for t in (240, 3600):
        w_true = np.concatenate([smooth_weights(t, 41, amplitude=0.6)[: t // 2],
                                 smooth_weights(t, 41, amplitude=0.6)[t // 2:] + 0.3])
        q = -((w_true @ basis.T + 1e-4 * rng.standard_normal((t, basis.shape[0]))) @ basis)
        runs, wall = {}, {}
        for name, kw in (("native", dict(backend="native")), ("card", dict(backend="torch", device=DEV)),
                         ("cpu", dict(backend="torch", device="cpu"))):
            runs[name], wall[name] = timed_call(lambda kw=kw: solve_sequence_qp(gram, q, DELTA, **kw))
        card = runs["card"].w
        vs_native, vs_cpu = np.abs(card - runs["native"].w).max(), np.abs(card - runs["cpu"].w).max()
        box = max(-card.min(), card.max() - 1.0, 0.0)
        smooth = np.abs(np.diff(card, axis=0)).max()
        active = (runs["native"].w <= 1e-6).mean(), (runs["native"].w >= 1 - 1e-6).mean(), \
            (np.abs(np.diff(runs["native"].w, axis=0)) >= DELTA - 1e-6).mean()
        launches, busy_us = admm_launches(gram, q)
        print(f"T={t}: native {wall['native'] * 1e3:.1f} ms ({runs['native'].iterations} iterations, f64); "
              f"ADMM card {wall['card'] * 1e3:.1f} ms ({runs['card'].iterations} iterations, "
              f"{launches:g} launches and {busy_us:.1f} us device busy an iteration); ADMM CPU "
              f"{wall['cpu'] * 1e3:.1f} ms ({runs['cpu'].iterations} iterations); card vs native {vs_native:.2e}, "
              f"card vs CPU {vs_cpu:.2e} (bound {QP_BOUND:.0e}); box {box:.1e}, max |dw| - delta "
              f"{smooth - DELTA:.1e}; active: {active[0]:.3f} at 0, {active[1]:.3f} at 1, {active[2]:.3f} of the "
              f"differences at delta; on {gpu_line}")
        check(vs_native <= QP_BOUND and vs_cpu <= QP_BOUND, f"QP T={t}: card vs native {vs_native}, vs CPU {vs_cpu}")
        check(box <= QP_BOX and smooth <= DELTA + QP_SMOOTH, f"QP T={t}: box {box}, smoothness {smooth}")
        check(min(active) > 0, f"QP T={t}: a constraint kind is never active {active}")
        check(launches == int(launches) and launches > 0, f"ADMM launches an iteration {launches}")
        qp_record[f"T{t}"] = {"native_ms": wall["native"] * 1e3, "native_iterations": runs["native"].iterations,
                              "card_ms": wall["card"] * 1e3, "card_iterations": runs["card"].iterations,
                              "cpu_ms": wall["cpu"] * 1e3, "cpu_iterations": runs["cpu"].iterations,
                              "launches_per_iteration": launches, "device_busy_us_per_iteration": busy_us,
                              "card_vs_native": float(vs_native), "card_vs_cpu": float(vs_cpu)}
    check(qp_record["T240"]["launches_per_iteration"] == qp_record["T3600"]["launches_per_iteration"],
          "ADMM launches an iteration differ between T=240 and T=3600")
    print(json.dumps({"pseudo_gt": {**{f"{k}_wall_s": v for k, v in walls.items()}, "qp": qp_record}}))
    return blend


def avi_chunks(path):
    """(the movi list's (fourcc, payload) chunks, idx1's entries) of an AVI."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    start = data.index(b"movi") + 4
    (size,) = struct.unpack("<I", data[start - 8:start - 4])
    chunks, i = [], start
    while i < start - 4 + size:
        fourcc, (n,) = data[i:i + 4], struct.unpack("<I", data[i + 4:i + 8])
        chunks.append((fourcc, data[i + 8:i + 8 + n]))
        i += 8 + n + n % 2
    check(data[i:i + 4] == b"idx1", f"{path}: no idx1 after movi")
    (n,) = struct.unpack("<I", data[i + 4:i + 8])
    return chunks, [data[i + 8 + k:i + 24 + k] for k in range(0, n, 16)]


def jpeg_size(data):
    """(height, width) from a JPEG's SOF0 segment."""
    import struct

    i = 2
    while data[i + 1] != 0xC0:
        check(data[i] == 0xFF and data[i + 1] != 0xDA, "JPEG: no SOF0 before the scan")
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return struct.unpack(">HH", data[i + 5:i + 9])


def phase_render(record, gpu_line, blend):
    from said_tpu_torch.cli import render, test_render
    from said_tpu_torch.utils.audio import load_audio
    from said_tpu_torch.utils.blendshape import save_blendshape_coeffs

    expected = dict(expected_launches(25), flash_attention=0)  # 60 frames: dense self-attention
    print("\n== phase 22: WAV -> CSV -> video: the inference CLI on a 1-s clip, render at 800x800 with audio, a "
          "heatmap against a perturbed CSV and PNGs, test_render over a two-file tree ==")
    cli_request(record, gpu_line, 22, 1.0, 25, ["--solver", "dpmpp_2m"], expected, seed=50)
    wav, csv_path = os.path.join(WORK, "clip1s.wav"), os.path.join(WORK, "clip1s.csv")
    _, coeffs = read_csv(csv_path)
    target = os.path.join(WORK, "clip1s_target.csv")
    save_blendshape_coeffs(np.clip(coeffs + np.random.default_rng(51).normal(0, 0.1, coeffs.shape), 0, 1)
                           .astype(np.float32), ARKIT_BLENDSHAPES, target)
    pid = PERSON_IDS_TEST[0]
    avi, png_dir = os.path.join(WORK, "clip1s.avi"), os.path.join(WORK, "clip1s_png")
    shutil.rmtree(png_dir, ignore_errors=True)
    t0 = time.perf_counter()
    out = render.main(["--neutral_path", os.path.join(blend, "templates_head", f"{pid}.obj"), "--blendshapes_dir",
                       os.path.join(blend, "blendshapes_head", pid), "--audio_path", wav, "--blendshape_coeffs_path",
                       csv_path, "--output_path", avi, "--show_difference", "True",
                       "--target_diff_blendshape_coeffs_path", target, "--save_images", "True",
                       "--output_images_dir", png_dir])
    render_wall = time.perf_counter() - t0
    chunks, index = avi_chunks(avi)
    frames = [p for c, p in chunks if c == b"00dc"]
    pcm = b"".join(p for c, p in chunks if c == b"01wb")
    want_pcm = (np.clip(load_audio(wav, SR), -1, 1) * 32767.0).astype("<i2").tobytes()
    sizes = {jpeg_size(f) for f in frames}
    print(f"render: {len(frames)} frames of {sizes} in {render_wall:.2f} s (rasterize "
          f"{1e3 * out['rasterize_s'] / out['frames']:.1f} ms a frame, JPEG encode and mux "
          f"{1e3 * out['encode_s'] / out['frames']:.1f} ms a frame, the rest PNGs and loading) on {gpu_line}; "
          f"{len(chunks)} chunks, {len(index)} idx1 entries, PCM {len(pcm)} bytes")
    check(out["frames"] == len(frames) == coeffs.shape[0] == 60, f"{len(frames)} video frames for {coeffs.shape}")
    check(all(f[:2] == b"\xff\xd8" and f[-2:] == b"\xff\xd9" for f in frames), "a frame is not an SOI..EOI JPEG")
    check(sizes == {(800, 800)}, f"frame sizes {sizes}")
    check(len(index) == len(chunks), f"idx1 has {len(index)} entries for {len(chunks)} chunks")
    check(pcm == want_pcm, "the AVI's PCM is not the clipped int16 WAV")
    check(len(os.listdir(png_dir)) == len(frames), "PNG count")

    split = os.path.join(WORK, "render_split")
    shutil.rmtree(split, ignore_errors=True)
    os.makedirs(os.path.join(split, "audio", pid))
    os.makedirs(os.path.join(split, "gen", pid))
    shutil.copy(wav, os.path.join(split, "audio", pid, "sentence01.wav"))
    for name, rows in (("sentence01.csv", coeffs[:5]), ("sentence01-1.csv", coeffs[5:10])):
        save_blendshape_coeffs(rows.astype(np.float32), ARKIT_BLENDSHAPES, os.path.join(split, "gen", pid, name))
    t0 = time.perf_counter()
    rendered = test_render.main(["--audio_dir", os.path.join(split, "audio"), "--coeffs_dir",
                                 os.path.join(split, "gen"), "--neutral_dir", os.path.join(blend, "templates_head"),
                                 "--blendshapes_dir", os.path.join(blend, "blendshapes_head"), "--output_dir",
                                 os.path.join(split, "out")])
    test_render_wall = time.perf_counter() - t0
    counts = {os.path.basename(p): sum(c == b"00dc" for c, _ in avi_chunks(p)[0]) for p in rendered}
    print(f"test_render: {counts} in {test_render_wall:.2f} s on {gpu_line}")
    check(counts == {"sentence01.avi": 5, "sentence01-1.avi": 5}, f"test_render wrote {counts}")
    print(json.dumps({"render": {"device": gpu_line, "frames": out["frames"], "size": [800, 800],
                                 "rasterize_ms_per_frame": 1e3 * out["rasterize_s"] / out["frames"],
                                 "encode_ms_per_frame": 1e3 * out["encode_s"] / out["frames"],
                                 "render_wall_s": render_wall, "test_render_wall_s": test_render_wall}}))


def write_safetensors(path, tensors):
    """A ``.safetensors`` file: 8-byte header length, JSON header, raw
    little-endian buffers (float32 here)."""
    import struct

    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        blob = t.contiguous().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for blob in blobs:
            f.write(blob)


def phase_hf_snapshot(gpu_line):
    print("\n== phase 23: an HF wav2vec2 snapshot as --init_weights: a base-width model.safetensors (wav2vec2. prefix, "
          "lm_head.*, masked_spec_embed) -> load_said_weights on the card -> 2 train-CLI steps ==")
    from said_tpu_torch.cli import train as train_cli
    from said_tpu_torch.cli._common import load_said_weights
    from said_tpu_torch.core.checkpoint import STATE_FILE

    snap = os.path.join(WORK, "hf_snapshot")
    shutil.rmtree(snap, ignore_errors=True)
    os.makedirs(snap)
    gen = torch.Generator().manual_seed(60)
    encoder = {"wav2vec2." + k: torch.randn(v.shape, generator=gen) * 0.02
               for k, v in build_said_model().audio_encoder.state_dict().items()}
    extras = {"lm_head.weight": torch.randn((32, 768), generator=gen), "lm_head.bias": torch.zeros(32)}
    check("wav2vec2.masked_spec_embed" in encoder, "the encoder has no masked_spec_embed")
    write_safetensors(os.path.join(snap, "model.safetensors"), {**encoder, **extras})
    print(f"snapshot: {len(encoder)} encoder tensors, "
          f"{sum(v.numel() for v in encoder.values()) / 1e6:.1f} M values, "
          f"{os.path.getsize(os.path.join(snap, 'model.safetensors')) / 2**20:.0f} MiB")

    def encoder_equal(state, label):
        bad = [k for k, v in encoder.items() if not torch.equal(state[k[len("wav2vec2."):]].cpu(), v)]
        check(not bad, f"{label}: audio-encoder tensors differ from the snapshot: {bad[:5]}")

    model, wall = timed_call(lambda: load_said_weights(build_said_model(), snap, seed=0).to(DEV))
    encoder_equal({k: v for k, v in model.audio_encoder.state_dict().items()}, "after load_said_weights")
    print(f"load_said_weights: {wall:.2f} s; every audio-encoder tensor on the card bit-equal to the snapshot")
    del model

    audio_dir, coeffs_dir = os.path.join(WORK, "train_tree", "audio"), os.path.join(WORK, "train_tree", "coeffs")
    out_dir = os.path.join(WORK, "train_out_hf")
    shutil.rmtree(out_dir, ignore_errors=True)
    # phase 15's tree: 16 clips in batches of 8, 2 steps in the epoch
    train_run("f32, 1 epoch from the snapshot", [
        "--device", DEV.type, "--audio_dir", audio_dir, "--coeffs_dir", coeffs_dir, "--batch_size", "8", "--seed",
        "0", "--output_dir", out_dir, "--epochs", "1", "--save_period", "1", "--val_period", "1000", "--export_pth",
        "", "--init_weights", snap], gpu_line)
    with open(os.path.join(out_dir, "SAiD", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    print("metrics:", lines)
    check(len(lines) == 1 and np.isfinite(lines[0]["Train/loss"]) and lines[0]["Train/nan_skipped"] == 0.0,
          f"train from the snapshot: {lines}")
    saved = torch.load(os.path.join(out_dir, "ckpt", "1", STATE_FILE), map_location="cpu", weights_only=True)
    check(saved["step"] == 2, f"train from the snapshot ran {saved['step']} steps")
    encoder_equal({k[len("audio_encoder."):]: v for k, v in saved["model"].items() if k.startswith("audio_encoder.")},
                  "after 2 train steps")
    print("after 2 train steps the frozen encoder is still bit-equal to the snapshot")


# ------------------------------------------------------------ parallel layer


def run_ranks(args, label, timeout=900):
    """``python -m torch.distributed.run --standalone`` with ``args``, from
    the checkout, in a session of its own that is killed whole if the run
    outlives ``timeout`` or this process stops; returns the wall seconds.
    The ranks' output is printed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall = time.perf_counter() - t0
    tail = "\n".join(line for line in out.splitlines() if "socket.cpp" not in line)[-3000:]
    print(f"{label}: exit {proc.returncode} in {wall:.1f} s (process start, build and init included)\n{tail}")
    check(proc.returncode == 0, f"{label}: the ranks exited with {proc.returncode}")
    return wall


def rank_main(kind, work):
    """A rank of phase 24b ("dp"), 25 ("sp"), 26 ("sptrain") or 27
    ("tptrain"): two ranks share cuda:0 over gloo (NCCL takes one rank a
    card); its results go to ``<work>/<kind>_rank<r>.pt``."""
    from said_tpu_torch.parallel.mesh import maybe_init_distributed, shutdown

    ctx = maybe_init_distributed("cuda", backend="gloo")
    configure_precision("float32")
    try:
        out = {"dp": dp_rank, "sp": sp_rank, "sptrain": sptrain_rank, "tptrain": tptrain_rank}[kind](ctx, work)
        torch.save(out, os.path.join(work, f"{kind}_rank{ctx.rank}.pt"))
    finally:
        shutdown(ctx)


def dp_rank(ctx, work):
    """Phase 24b on one rank: one full-width train step (f32, train mode)
    on its rows of profile_train's batch of 8, then on rank 0 the same step
    of one process on all 8 rows; the gradients the optimizer receives,
    the loss, the parameters and EMA after the step, the launches."""
    from said_tpu_torch import profile_train
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.parallel.mesh import MeshConfig, SlicedGenerator, make_mesh, rank_rows
    from said_tpu_torch.train.said_train import train_step

    data = make_mesh(MeshConfig(data=ctx.world), ctx).data
    schedule = DiffusionSchedule.create(1000)
    batch = profile_train.make_batch(ctx.device)
    b = batch["waveform"].shape[0]
    out = {}
    for mode in ("dp", "one") if ctx.rank == 0 else ("dp",):
        state, gen = profile_train.make_cell("float32", ctx.device)
        seen = []
        update = state.optimizer.update
        state.optimizer.update = lambda grads: (seen.append([g.detach().cpu() for g in grads]), update(grads))[1]
        zero_launches()
        t0 = time.perf_counter()
        if mode == "dp":
            rows = rank_rows(b, data.size, data.index)
            local = {k: v[rows] if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
            metrics = train_step(state, schedule, dict(local, global_batch=b), SlicedGenerator(gen, 0, rows, b), data)
        else:
            metrics = train_step(state, schedule, batch, gen)
        torch.cuda.synchronize()
        out[mode] = {"loss": metrics["loss"], "nan_skipped": metrics["nan_skipped"], "ms": 1e3 * (
            time.perf_counter() - t0), "launches": read_launches(), "grads": dict(zip(state.params, seen[0])),
            "params": {n: p.detach().cpu() for n, p in state.params.items()},
            "ema": {n: e.cpu() for n, e in state.ema.items()}}
        del state
    return out


def sp_rank(ctx, work):
    """Phase 25 on one rank: the full-width SAID (random weights, seed 0) on
    the 60-s clip with injected latents, 20 DDIM and 25 DPM++ steps, CFG
    2.0, frame-sharded over the two ranks; each request's result, wall
    time, launches and collectives (timed: the card synchronised around
    each); then on rank 0 the same requests unsharded."""
    from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from said_tpu_torch.utils.audio import load_audio

    seq = make_mesh(MeshConfig(data=1, seq=ctx.world), ctx).seq
    seq.timed = True
    pipe = SAIDPipeline(random_init_(build_said_model(), seed=0).to(ctx.device).eval())
    wave = process_audio(load_audio(os.path.join(work, "clip60s.wav"), SR))
    latents = np.random.default_rng(7).standard_normal((1, SP_FRAMES, 32)).astype(np.float32)
    out = {}
    for solver, steps in SP_REQUESTS:
        for run in ("sharded", "unsharded", "unsharded, split GroupNorm") if ctx.rank == 0 else ("sharded",):
            seq.calls, seq.seconds = 0, 0.0
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with split_group_norm(run.endswith("split GroupNorm")):
                res = pipe.inference(wave, num_inference_steps=steps, guidance_scale=2.0, solver=solver,
                                     latents=latents, seq_group=seq if run == "sharded" else None).result
            torch.cuda.synchronize()
            out[(solver, steps, run)] = {"result": res, "wall": time.perf_counter() - t0, "launches": read_launches(),
                                  "collective_s": seq.seconds, "collectives": seq.calls}
    return out


@contextlib.contextmanager
def split_group_norm(on):
    """With ``on``, every GroupNorm of the unsharded run takes the split (the
    sharded route's kernels) in place of the one-launch kernel: the same
    function by another correct kernel, a measure of how far the chain
    moves the result for a kernel's rounding."""
    if not on:
        yield
        return
    saved = norms._SPLIT_MIN_T
    norms._SPLIT_MIN_T = 0
    norms.group_norm_plan.cache_clear()
    try:
        yield
    finally:
        norms._SPLIT_MIN_T = saved
        norms.group_norm_plan.cache_clear()


# one step first: before the chain amplifies anything, the sharded run is
# held to LONG_BOUND (one denoiser call, card against card)
SP_REQUESTS = (("ddim", 1), ("ddim", 20), ("dpmpp_2m", 25))


def phase_data_parallel(record, gpu_line):
    print("\n== phase 24: data-parallel training: (a) torch.distributed.run --nproc_per_node 1 (NCCL) of the train "
          "CLI against phase 15's single process; (b) two ranks sharing cuda:0 over gloo, one full-width step at "
          "batch 8 of 300-frame windows, against one process ==")
    root = os.path.join(WORK, "train_tree")
    out_dir = os.path.join(WORK, "train_out_nccl1")
    shutil.rmtree(out_dir, ignore_errors=True)
    # phase 15's f32 run to its epoch-2 export: same flags, 2 epochs
    run_ranks(["--nproc_per_node", "1", "-m", "said_tpu_torch.cli.train", "--device", "cuda", "--audio_dir",
               os.path.join(root, "audio"), "--coeffs_dir", os.path.join(root, "coeffs"), "--batch_size", "8",
               "--seed", "0", "--val_repeat", "1", "--output_dir", out_dir, "--dtype", "float32", "--epochs", "2",
               "--save_period", "2", "--val_period", "4", "--mesh_data", "1"], "24a: NCCL, one rank, 2 epochs")
    got = torch.load(os.path.join(out_dir, "2.pth"), weights_only=True)
    want = torch.load(os.path.join(WORK, "train_out", "2.pth"), weights_only=True)
    same = got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    print(f"24a: 2.pth of the one-rank NCCL run {'bit-identical' if same else 'DIFFERS'} to phase 15's "
          f"({len(want)} tensors)")
    check(same, "the one-rank NCCL train run's 2.pth is not bit-identical to phase 15's")
    data_parallel_step(gpu_line)


def data_parallel_step(gpu_line):
    """Phase 24b: two ranks over gloo on one card against one process."""
    work = os.path.join(WORK, "dp")
    os.makedirs(work, exist_ok=True)
    wall = run_ranks(["--nproc_per_node", "2", os.path.join(REPO, "chip_smoke.py"), "--rank", "dp", work],
                     "24b: two ranks over gloo on one card")
    r0, r1 = (torch.load(os.path.join(work, f"dp_rank{r}.pt"), weights_only=False) for r in range(2))
    dp, one = r0["dp"], r0["one"]
    loss_rel = abs(dp["loss"] - one["loss"]) / abs(one["loss"])
    worst, nonzero = 0.0, 0
    for name, want in one["grads"].items():
        check(torch.equal(dp["grads"][name], r1["dp"]["grads"][name]), f"24b: ranks clip different gradients {name}")
        scale = float(torch.linalg.vector_norm(want))
        if scale > 0:
            nonzero += 1
            worst = max(worst, float(torch.linalg.vector_norm(dp["grads"][name] - want)) / scale)
    identical = all(torch.equal(dp[key][n], r1["dp"][key][n]) for key in ("params", "ema") for n in dp[key])
    launches = {k: dp["launches"][k] + r1["dp"]["launches"][k] for k in dp["launches"]}
    print(f"24b: loss {dp['loss']:.7f} (one process {one['loss']:.7f}, relative {loss_rel:.2e}, bound "
          f"{DP_BOUND['loss']:.0e}); worst gradient relative L2 {worst:.2e} over {nonzero} nonzero tensors (bound "
          f"{DP_BOUND['grad']:.0e}); parameters and EMA identical on both ranks after the step: {identical}; "
          f"launches summed over the ranks {launches} (one process {one['launches']}); step ms rank 0 "
          f"{dp['ms']:.1f}, rank 1 {r1['dp']['ms']:.1f}, one process {one['ms']:.1f} (two ranks sharing one card "
          f"over gloo: a numerics check, not a speed figure); run {wall:.1f} s on {gpu_line}")
    check(dp["nan_skipped"] == 0.0 and np.isfinite(dp["loss"]) and loss_rel <= DP_BOUND["loss"],
          f"24b: loss {dp['loss']} against {one['loss']}")
    check(nonzero > 0.9 * len(one["grads"]) and worst <= DP_BOUND["grad"], f"24b: gradient relative L2 {worst}")
    check(identical, "24b: the ranks' parameters or EMA differ after the step")
    check(all(launches[k] > 0 for k in ("group_norm_masked", "layer_norm", "strided_conv_gelu")),
          f"24b: a kernel of the training path was not launched: {launches}")


def phase_sequence_parallel(record, gpu_line):
    print(f"\n== phase 25: sequence-parallel serving, two ranks sharing cuda:0 over gloo: the full-width SAID "
          f"(random weights) on a 60-s clip ({SP_FRAMES} frames, {SP_FRAMES // 2} a rank), "
          f"{' and '.join(f'{n} {s}' for s, n in SP_REQUESTS)} steps, CFG 2.0, injected latents, against the "
          f"unsharded card run ==")
    work = os.path.join(WORK, "sp")
    os.makedirs(work, exist_ok=True)
    write_wav(os.path.join(work, "clip60s.wav"), 60.0, seed=2)
    wall = run_ranks(["--nproc_per_node", "2", os.path.join(REPO, "chip_smoke.py"), "--rank", "sp", work],
                     "25: two ranks over gloo on one card")
    ranks = [torch.load(os.path.join(work, f"sp_rank{r}.pt"), weights_only=False) for r in range(2)]
    conv0 = norms.group_norm_plan(1, (60 * SR - 10) // 5 + 1, 512, 512)
    check(conv0.route == "triton", f"conv_0's GroupNorm plan at 60 s is {conv0}, not the split")
    summary = {}
    for solver, steps in SP_REQUESTS:
        key = (solver, steps)
        sp, one = ranks[0][key + ("sharded",)], ranks[0][key + ("unsharded",)]
        split = ranks[0][key + ("unsharded, split GroupNorm",)]["result"]
        check(np.array_equal(sp["result"], ranks[1][key + ("sharded",)]["result"]),
              f"25 {solver}: the ranks' results differ")
        res, ref = sp["result"], one["result"]
        mae, mx = float(np.abs(res - ref).mean()), float(np.abs(res - ref).max())
        floor = float(np.abs(split - ref).max())
        max_bound = LONG_BOUND if steps == 1 else max(SP_BOUND["max"], SP_FLOOR_FACTOR * floor)
        launches = {k: sum(r[key + ("sharded",)]["launches"][k] for r in ranks) for k in KERNELS}
        per_rank = expected_launches(steps) | {"group_norm": 1, "group_norm_stats": 15 * steps,
                                               "group_norm_apply": 15 * steps}
        want = {k: 2 * n for k, n in per_rank.items()}
        shares = [r[key + ("sharded",)]["collective_s"] / r[key + ("sharded",)]["wall"] for r in ranks]
        print(f"25 {solver} {steps} steps: {res.shape[1]} rows, MAE {mae:.2e} max {mx:.2e} against the unsharded "
              f"card run (bounds {SP_BOUND['mae']:.0e} and {max_bound:.2e}); the unsharded run with its GroupNorms "
              f"on the split moves by max {floor:.2e}, MAE {float(np.abs(split - ref).mean()):.2e}; wall rank 0 "
              f"{sp['wall']:.2f} s, rank 1 {ranks[1][key + ('sharded',)]['wall']:.2f} s, in collectives "
              f"{shares[0]:.1%} / {shares[1]:.1%} "
              f"({sp['collectives']} all_gathers a rank, the card synchronised around each); the unsharded "
              f"request {one['wall']:.2f} s (two ranks sharing one card over gloo: a numerics check, not a speed "
              f"figure) on {gpu_line}")
        print(f"25 {solver} {steps} steps: launches summed over the ranks {launches}; conv_0's GroupNorm takes the split "
              f"({conv0.chunks} chunks), the one-launch kernel never runs")
        check(res.shape == (1, SP_FRAMES, 32) and np.isfinite(res).all() and res.min() >= 0.0 and res.max() <= 1.0,
              f"25 {solver}: result {res.shape} not finite in [0, 1]")
        check(res.std() > 1e-3 and mae <= SP_BOUND["mae"] and mx <= max_bound,
              f"25 {solver}: MAE {mae} max {mx} (bound {max_bound}; std {res.std()})")
        check(launches == want, f"25 {solver}: launch counts {launches} != {want}")
        label = f"60s SP 2 ranks {steps} steps {solver}"
        for name, n in launches.items():
            record[name].setdefault("launches_by_request", {})[label] = n
        if key == ("ddim", 20):
            for name in ("group_norm_stats", "group_norm_apply"):
                record[name]["launches"] = launches[name]
            record["flash_attention"]["sp f32"]["launches"] = launches["flash_attention"]
        summary[f"{solver} {steps}"] = {
            "mae": mae, "max": mx, "max_bound": max_bound, "split_group_norm_max": floor,
            "wall_s": [r[key + ("sharded",)]["wall"] for r in ranks], "collective_share": shares,
            "collectives_per_rank": sp["collectives"], "unsharded_wall_s": one["wall"]}
    print(json.dumps({"sequence_parallel": dict(summary, device=gpu_line, ranks=2, backend="gloo, one card shared",
                                                frames=SP_FRAMES, run_s=wall)}))


def train_cell(device, model_axis=None):
    """A train state of the full-width model (f32, random weights from seed
    0, as ``profile_train.make_cell``), sharded over ``model_axis``, and its
    dropout generator."""
    from said_tpu_torch.parallel.tensor import shard_model_
    from said_tpu_torch.train.said_train import TrainConfig, TrainState

    model = random_init_(build_said_model(dtype="float32"), seed=0).to(device)
    shard_model_(model, model_axis)
    return TrainState(model, TrainConfig()), torch.Generator(device=device).manual_seed(0)


def captured_step(state, schedule, inputs, gen, group, axes=()):
    """One ``train_step`` with the launch counters zeroed just before it and
    read just after: the loss, the gradients the optimizer receives (whole,
    on the CPU), the host ms (synchronised), and the collectives of
    ``axes`` (count, host seconds)."""
    from said_tpu_torch.train.said_train import train_step

    seen = []
    update = state.optimizer.update
    state.optimizer.update = lambda grads: (seen.append(grads), update(grads))[1]
    for axis in axes:
        axis.calls, axis.seconds = 0, 0.0
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = train_step(state, schedule, inputs, gen, group)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    return {"loss": metrics["loss"], "nan_skipped": metrics["nan_skipped"], "ms": ms, "launches": launches,
            "grads": whole_of(state, dict(zip(state.params, seen[0]))),
            "collectives": sum(a.calls for a in axes), "collective_s": sum(a.seconds for a in axes)}


def whole_of(state, named):
    """Whole tensors (gathered over the model axis), on the CPU."""
    from said_tpu_torch.parallel.tensor import gather_state_dict

    tp = state.tensor_parallel
    if tp is not None:
        named = gather_state_dict(named, tp.plan, tp.group)
    return {n: t.detach().cpu() for n, t in named.items()}


def after_step(state):
    """The parameters and EMA after a step: whole, and this rank's own."""
    return {"params": whole_of(state, state.params), "ema": whole_of(state, state.ema),
            "local_params": {n: p.detach().cpu() for n, p in state.params.items()},
            "local_ema": {n: e.cpu() for n, e in state.ema.items()}}


def sp_train_batch():
    """Phase 26's batch (numpy): 2 rows of a 4200-frame bucket with 4190
    real frames and spec-augment masks, as the train CLI builds it."""
    from said_tpu_torch.models.wav2vec2 import compute_time_mask_indices

    rng = np.random.default_rng(26)
    n = SPT_REAL * SR // FPS
    wave = process_audio(0.1 * rng.standard_normal((2, n)).astype(np.float32))
    wave = np.pad(wave, ((0, 0), (0, -(-SPT_FRAMES * SR // FPS) - n)))
    coeffs = np.pad(rng.uniform(0, 1, (2, SPT_REAL, 32)).astype(np.float32),
                    ((0, 0), (0, SPT_FRAMES - SPT_REAL), (0, 0)))
    mask = np.pad(compute_time_mask_indices((2, SPT_REAL), rng=rng), ((0, 0), (0, SPT_FRAMES - SPT_REAL)))
    return {"waveform": wave, "coeffs": coeffs, "cond": rng.uniform(size=2) > 0.1, "mask_time_indices": mask,
            "input_length": n}


def sptrain_rank(ctx, work):
    """Phase 26 on one rank: one train step of the full-width SAID on its
    2100 frames of the 4200-frame window, then on rank 0 the same step of
    one process on the whole window."""
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from said_tpu_torch.parallel.seq import frames_of

    mesh = make_mesh(MeshConfig(data=1, seq=ctx.world), ctx)
    mesh.seq.timed = mesh.data_seq.timed = True
    schedule = DiffusionSchedule.create(1000)
    batch = sp_train_batch()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)

    out = {}
    for mode in ("sp", "one") if ctx.rank == 0 else ("sp",):
        seq = mesh.seq if mode == "sp" else None
        frames = frames_of(SPT_FRAMES, seq) if seq else slice(None)
        inputs = {"waveform": dev(batch["waveform"]), "coeffs": dev(batch["coeffs"][:, frames]),
                  "cond": dev(batch["cond"]), "std": None, "blendshape_delta": None,
                  "mask_time_indices": dev(batch["mask_time_indices"]), "window_real": SPT_REAL,
                  "input_length": batch["input_length"], "seq_group": seq}
        state, gen = train_cell(ctx.device)
        out[mode] = captured_step(state, schedule, inputs, gen, mesh.data_seq if seq else None,
                                  (mesh.seq, mesh.data_seq) if seq else ())
        out[mode].update(after_step(state))
        del state
        torch.cuda.empty_cache()
    return out


def tptrain_rank(ctx, work):
    """Phase 27 on one rank: one train step and one validation step (with
    the EMA weights, as the CLI validates) of the full-width SAID sharded
    over a model axis of the two ranks, at profile_train's batch; then on
    rank 0 the same of one process."""
    from said_tpu_torch import profile_train
    from said_tpu_torch.diffusion.schedule import DiffusionSchedule
    from said_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from said_tpu_torch.train.said_train import eval_step

    mesh = make_mesh(MeshConfig(data=1, model=ctx.world), ctx)
    mesh.model.timed = True
    schedule = DiffusionSchedule.create(1000)
    batch = profile_train.make_batch(ctx.device)
    out = {}
    for mode in ("tp", "one") if ctx.rank == 0 else ("tp",):
        state, gen = train_cell(ctx.device, mesh.model if mode == "tp" else None)
        out[mode] = captured_step(state, schedule, batch, gen, None, (mesh.model,) if mode == "tp" else ())
        out[mode].update(after_step(state))
        out[mode]["sharded"] = sorted(state.tensor_parallel.plan) if mode == "tp" else []
        zero_launches()
        with state.ema_weights():
            out[mode]["eval"] = eval_step(state.model, schedule, batch, state.config,
                                          torch.Generator(device=ctx.device).manual_seed(1))
        torch.cuda.synchronize()
        out[mode]["eval_launches"] = read_launches()
        del state
        torch.cuda.empty_cache()
    return out


def compare_parallel_step(label, got, peer, want, identical):
    """A two-rank train step against one process's: (loss relative, worst
    gradient relative L2, nonzero gradients, {"params", "ema"}: all tensors
    together, relative L2). Fails on the bounds, on ranks that clip
    different gradients, and on ranks whose parameters or EMA named in
    ``identical`` differ after the step."""
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    worst, nonzero = 0.0, 0
    for name, w in want["grads"].items():
        check(torch.equal(got["grads"][name], peer["grads"][name]), f"{label}: ranks clip different gradients {name}")
        scale = float(torch.linalg.vector_norm(w))
        if scale > 0:
            nonzero += 1
            worst = max(worst, float(torch.linalg.vector_norm(got["grads"][name] - w)) / scale)
    after = {key: rel_l2(torch.cat([got[key][n].reshape(-1) for n in want[key]]),
                         torch.cat([w.reshape(-1) for w in want[key].values()])) for key in ("params", "ema")}
    for key in ("local_params", "local_ema"):
        for n in identical:
            check(torch.equal(got[key][n], peer[key][n]), f"{label}: the ranks' {key} {n} differ after the step")
    check(got["nan_skipped"] == 0.0 and np.isfinite(got["loss"]) and loss_rel <= PT_BOUND["loss"],
          f"{label}: loss {got['loss']} against {want['loss']}")
    check(nonzero > 0.9 * len(want["grads"]) and worst <= PT_BOUND["grad"], f"{label}: gradient relative L2 {worst}")
    check(max(after.values()) <= PT_BOUND["params"], f"{label}: parameters and EMA after the step {after}")
    return loss_rel, worst, nonzero, after


def phase_sequence_parallel_training(record, gpu_line):
    print(f"\n== phase 26: sequence-parallel training, two ranks sharing cuda:0 over gloo: one full-width train step "
          f"(f32) at batch 2 of a {SPT_FRAMES}-frame bucket with {SPT_REAL} real frames ({SPT_FRAMES // 2} a rank), "
          f"against one process ==")
    work = os.path.join(WORK, "sptrain")
    os.makedirs(work, exist_ok=True)
    wall = run_ranks(["--nproc_per_node", "2", os.path.join(REPO, "chip_smoke.py"), "--rank", "sptrain", work],
                     "26: two ranks over gloo on one card")
    r0, r1 = (torch.load(os.path.join(work, f"sptrain_rank{r}.pt"), weights_only=False) for r in range(2))
    sp, one = r0["sp"], r0["one"]
    loss_rel, worst, nonzero, after = compare_parallel_step("26", sp, r1["sp"], one, list(one["local_params"]))
    launches = {k: sp["launches"][k] + r1["sp"]["launches"][k] for k in KERNELS}
    want = {"group_norm": 0, "group_norm_masked": 2 * 1, "layer_norm": 2 * one["launches"]["layer_norm"],
            "geglu_ffn": 0, "strided_conv_gelu": 2 * one["launches"]["strided_conv_gelu"], "flash_attention": 2 * 4,
            "group_norm_stats": 2 * 15, "group_norm_apply": 2 * 15}
    shares = [r["sp"]["collective_s"] / (r["sp"]["ms"] / 1e3) for r in (r0, r1)]
    print(f"26: loss {sp['loss']:.7f} (one process {one['loss']:.7f}, relative {loss_rel:.2e}, bound "
          f"{PT_BOUND['loss']:.0e}); worst gradient relative L2 {worst:.2e} over {nonzero} nonzero tensors (bound "
          f"{PT_BOUND['grad']:.0e}); parameters / EMA after the step against one process {after['params']:.2e} / "
          f"{after['ema']:.2e} (bound {PT_BOUND['params']:.0e}); parameters and EMA identical on both ranks")
    print(f"26: launches summed over the ranks {launches} (one process {one['launches']}): K1 with the window's "
          f"length over the gathered {SPT_FRAMES} keys, the masked split's stats and apply, no one-launch GroupNorm")
    print(f"26: step ms rank 0 {sp['ms']:.1f}, rank 1 {r1['sp']['ms']:.1f} ({sp['collectives']} all_gathers a rank, "
          f"{shares[0]:.1%} / {shares[1]:.1%} of the step in them, the card synchronised around each), one process "
          f"{one['ms']:.1f} (two ranks sharing one card over gloo: a numerics check, not a speed figure); run "
          f"{wall:.1f} s on {gpu_line}")
    check(one["launches"]["flash_attention"] == 4 and one["launches"]["group_norm_stats"] == 0,
          f"26: one process's launches {one['launches']}")
    check(launches == want, f"26: launch counts {launches} != {want}")
    for name, n in launches.items():
        record[name].setdefault("launches_by_request", {})[f"SP train step {SPT_FRAMES} frames 2 ranks"] = n
    record["flash_attention"]["sp train f32"]["launches"] = launches["flash_attention"]
    record["group_norm_stats"]["masked f32"]["launches"] = launches["group_norm_stats"]
    print(json.dumps({"sequence_parallel_training": {
        "loss_rel": loss_rel, "grad_rel_l2": worst, "after_step_rel_l2": after, "launches": launches,
        "step_ms": [sp["ms"], r1["sp"]["ms"]], "one_process_ms": one["ms"], "all_gathers_per_rank": sp["collectives"],
        "collective_share": shares, "device": gpu_line, "ranks": 2, "backend": "gloo, one card shared",
        "frames": SPT_FRAMES, "real_frames": SPT_REAL, "run_s": wall}}))


def phase_tensor_parallel_training(record, gpu_line):
    print("\n== phase 27: tensor-parallel training, two ranks (model axis 2) sharing cuda:0 over gloo: one full-width "
          "train step (f32) at batch 8 of 300-frame windows and one validation step, against one process ==")
    work = os.path.join(WORK, "tptrain")
    os.makedirs(work, exist_ok=True)
    wall = run_ranks(["--nproc_per_node", "2", os.path.join(REPO, "chip_smoke.py"), "--rank", "tptrain", work],
                     "27: two ranks over gloo on one card")
    r0, r1 = (torch.load(os.path.join(work, f"tptrain_rank{r}.pt"), weights_only=False) for r in range(2))
    tp, one = r0["tp"], r0["one"]
    replicated = [n for n in one["local_params"] if n not in tp["sharded"]]
    loss_rel, worst, nonzero, after = compare_parallel_step("27", tp, r1["tp"], one, replicated)
    launches = {k: tp["launches"][k] + r1["tp"]["launches"][k] for k in KERNELS}
    eval_launches = {k: tp["eval_launches"][k] + r1["tp"]["eval_launches"][k] for k in KERNELS}
    eval_rel = abs(tp["eval"]["loss"] - one["eval"]["loss"]) / abs(one["eval"]["loss"])
    print(f"27: {len(tp['sharded'])} sharded tensors, {len(replicated)} replicated trainable tensors identical on "
          f"both ranks; loss {tp['loss']:.7f} (one process {one['loss']:.7f}, relative {loss_rel:.2e}); worst "
          f"gradient relative L2 {worst:.2e} over {nonzero} nonzero tensors; parameters / EMA after the step against "
          f"one process {after['params']:.2e} / {after['ema']:.2e} (bound {PT_BOUND['params']:.0e}); validation "
          f"loss {tp['eval']['loss']:.7f} (one process {one['eval']['loss']:.7f}, relative {eval_rel:.2e})")
    print(f"27: launches summed over the ranks, train step {launches} (one process {one['launches']}), validation "
          f"step {eval_launches} (one process {one['eval_launches']}): K8 at I = 384 a rank")
    print(f"27: step ms rank 0 {tp['ms']:.1f}, rank 1 {r1['tp']['ms']:.1f} ({tp['collectives']} all_gathers a rank "
          f"on the model axis), one process {one['ms']:.1f} (two ranks sharing one card over gloo: a numerics "
          f"check, not a speed figure); run {wall:.1f} s on {gpu_line}")
    check(eval_rel <= PT_BOUND["loss"], f"27: validation loss {tp['eval']['loss']} against {one['eval']['loss']}")
    check(launches == {k: 2 * n for k, n in one["launches"].items()}, f"27: train step launches {launches}")
    check(eval_launches == {k: 2 * n for k, n in one["eval_launches"].items()} and eval_launches["geglu_ffn"] == 8,
          f"27: validation launches {eval_launches}")
    for name, n in launches.items():
        record[name].setdefault("launches_by_request", {})["TP train step 8x300 2 ranks"] = n
    for name, n in eval_launches.items():
        record[name].setdefault("launches_by_request", {})["TP validation step 8x300 2 ranks"] = n
    record["geglu_ffn"]["tp f32"]["launches"] = eval_launches["geglu_ffn"]
    print(json.dumps({"tensor_parallel_training": {
        "loss_rel": loss_rel, "grad_rel_l2": worst, "after_step_rel_l2": after, "eval_loss_rel": eval_rel,
        "launches": launches, "eval_launches": eval_launches, "step_ms": [tp["ms"], r1["tp"]["ms"]],
        "one_process_ms": one["ms"], "all_gathers_per_rank": tp["collectives"], "device": gpu_line, "ranks": 2,
        "backend": "gloo, one card shared", "run_s": wall}}))


def main():
    os.makedirs(WORK, exist_ok=True)
    print("== phase 1: environment and build ==")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  CUDA {torch.version.cuda}")
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(gpu_line)
    t0 = time.perf_counter()
    _build.library()
    print(f"nvcc build of said_tpu_torch/csrc: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qp_native.load()  # raises with g++'s output if the build fails
    print(f"g++ build of said_tpu_torch/optimize/csrc/qp_solver.cpp: {time.perf_counter() - t0:.1f} s "
          f"({qp_native.library_path().relative_to(REPO)})")
    configure_precision("float32")
    t0 = time.perf_counter()
    x, w, b = randn((2, 8, 192), 0), randn((192,), 0), randn((192,), 0)
    norms.layer_norm_kernel(x, w, b)  # CUDA C++, in the library just built
    norms.group_norm_kernel(x, 32, w, b)
    norms.group_norm_masked_kernel(x, 32, w, b, torch.full((2,), 5, dtype=torch.int32, device=DEV))
    x = randn((1, norms._SPLIT_MIN_T + 1, 192), 0)  # the split's two Triton kernels
    norms.group_norm_masked_kernel(x, 32, w, b, torch.full((1,), 5, dtype=torch.int32, device=DEV))
    torch.cuda.synchronize()
    print(f"Triton compile of the GroupNorm split, first LayerNorm and GroupNorm launches: "
          f"{time.perf_counter() - t0:.1f} s")

    record = {name: {"name": name, "route": route, "source": src, "replaces": rep, "replaces_function": fn}
              for name, (_, route, src, rep, fn) in KERNELS.items()}
    for name, also in ALSO_REPLACES.items():
        record[name]["also_replaces"] = also
    for name, (route, src) in SPLIT_ROUTE.items():
        record[name].update(split_route=route, split_source=src)
    phase_kernels(record)
    check_sharded_group_norm()
    phase_autograd()
    phase_request(record, gpu_line)
    model, wave, latents = phase_card_vs_cpu()
    phase_bf16_vs_f32(model, wave, latents)
    del model
    phase_bf16()
    whole_clip_wall = phase_long_requests(record, gpu_line)
    phase_long_card_vs_cpu()
    phase_eval_cli(record, gpu_line)
    phase_mixed_lengths()
    phase_bucketed_long(record, gpu_line)
    phase_train_card_vs_cpu(13, batch=2, frames=600, window_real=597, flash=False)
    card_model = phase_train_card_vs_cpu(14, batch=1, frames=2400, window_real=2400, flash=True)
    phase_blockwise_backward(card_model)
    del card_model
    phase_train_cli(gpu_line)
    phase_streaming_cli(record, gpu_line, whole_clip_wall)
    phase_streaming_card_vs_cpu()
    phase_layer_feature_norm()
    phase_vae_train_step()
    phase_vae_clis(gpu_line)
    blend = phase_pseudo_gt(gpu_line)
    phase_render(record, gpu_line, blend)
    phase_hf_snapshot(gpu_line)

    phase_data_parallel(record, gpu_line)
    phase_sequence_parallel(record, gpu_line)
    phase_sequence_parallel_training(record, gpu_line)
    phase_tensor_parallel_training(record, gpu_line)

    print("\nall phases passed")
    print(gpu_line)
    print(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 24b, 25, 26 or 27, started by torch.distributed.run
        rank_main(sys.argv[2], sys.argv[3])
    else:
        main()
