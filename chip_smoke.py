#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card: the split-parallel
training paths (the 2-D mesh in sim form, checkpoint and resume, and the
spmd form over torch.distributed included) and the transformer serve and
train paths, serving across ranks included.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failure exits non-zero; nothing is caught and continued):

1. device  -- requires a CUDA card; prints the nvidia-smi name/power line.
2. build   -- compiles the CUDA sources of ``src/repro_torch/csrc``, one
              ``nvcc`` each, all started together.
3. kernels -- at the shapes the paths give each kernel, holds each kernel
              against its plain torch version and checks it repeats bit for
              bit, and times it (CUDA events, median of 30 launches after
              warm-up) beside the plain version, a library call computing
              the same function where one exists, and the least time the
              card could take (``bound_ms``). The gather_segsum kernels at
              the first papers-s batch's input layer (layer 1 for the
              unweighted row adjoint, which SAGE and GCN never launch at the
              input layer): the forward and the row adjoint, weighted and
              not, bitwise against their plain versions on a CPU copy (and
              within 3e-5 / 3e-4 of ``torch.sparse.mm``), and the weight
              adjoint bitwise against its plain version on a CPU copy (it
              sums each head in the tree order the plain version states;
              within 3e-4 of ``torch.sparse.sampled_addmm``). The row
              adjoint's walk (``src_sorted_csr``, three kernels) is held
              bitwise against its plain version at layer 1
              and at the input layer and timed by events, device and host;
              the row adjoint's row also gives the walk's times and the
              whole adjoint's (build + kernel). ``kernel_detail`` lines name
              the kernels one call runs (the forward's must hold no
              ``searchsorted``). The wavefront
              expansion at the device sampler's largest launch (P*N rows of
              the largest frontier cap, fan-out 15): bitwise, beside an
              empty kernel on the same grid (the launch floor). The
              shuffle adjoint at layer 1 of the first papers-s batch (the
              widest shuffle a gradient flows through) at the hidden width
              (F=256): bitwise against its plain version on a CPU copy,
              beside torch's own adjoint (``index_put_`` with accumulate);
              its ``kernel_detail`` must name no
              ``indexing_backward_kernel``. The same kernel as the self
              rows' adjoint at layer 1 (one group), bitwise. The packed
              segment sum (F=128) and edge softmax (H=4) on the input layer's
              edges, all P splits flattened with dst offset by split: the
              sum bitwise against its plain version on a CPU copy in f32
              (index_add_ sums in index order there, as the kernel does),
              3e-5 in bf16 and f16; the softmax 3e-5.
              The decode attention at SmolLM-135M's serve shape (B=8, H=9,
              KV=3, D=64, S=1088) and the other dense configs' heads at B=8,
              S=4096, f32 (2e-4/2e-5) and bf16 (the f32 result from the
              same inputs, within the rounding of p and of the output),
              cache_len 1, mid and S; timed in bf16 with a full cache, cold
              in L2. Its partial output (o float32, m, d; the call a
              sequence-sharded decode makes) at phase 24's shapes, f32 and
              bf16: a shard with no valid row exactly o = 0, m = -1e30,
              d = 0; else o within the bound, m and d within 2e-4/2e-5 of
              the plain version; bit for bit on repeat.
4. main    -- the trainer's main path at full width: papers-s, SAGE (128 ->
              256 -> 256 -> 16), fan-outs 15,15,15, batch 1024, P=4 splits in
              sim form; 3 epochs of 3 steps on the serial plan source and on
              the pipelined one (2 producer threads), whose losses must be
              bitwise equal. Each run emits every step's wait, staging and
              sync ms, each epoch's wall and its source's stats (queue
              occupancy, signature hit rate). Presampling is cut to 2 epochs.
4b. staging -- ``python -m repro_torch.profile_step --plan-source
              pipelined`` in a process of its own: one ``torch.profiler``
              window of two steady pipelined SAGE steps. Fails if a pageable
              host-to-device copy (``Memcpy HtoD (Pageable -> Device)``)
              falls in it or if a step makes other than two pinned ones;
              emits the pinned copies' count and device ms a step, and the
              window's device idle share.
5. models  -- GCN and GAT (4 heads) at the same widths: GCN one epoch of 2
              steps, GAT two (phase 18 resumes inside its second).
6. parity  -- tiny graph, 2 layers, hidden 64: 3 steps on the card (kernels)
              and on the CPU (plain versions) from the same weights agree to
              rtol 1e-4: split for all three models, split with replication
              (10% of the rows) for SAGE and GAT, dp for all three.
7. device source -- the main path's SAGE run with ``plan_source="device"``
              and ``"device_pipelined"`` (producer threads sampling on streams
              of their own): sampling on the card (the cooperative sampler and
              its wavefront kernel), 3 epochs of 3 steps each, bitwise equal
              losses. Fails unless a batch was sampled on the card without a
              fallback, and unless the wavefront launches equal the layers
              times the device sampling runs, for both sources. The card's ``sample_batch(targets, 0, 0)`` is held
              bitwise against a ``DeviceSampler`` on the CPU (plain versions)
              with the same shards and caps, and one ``_sample_device`` call
              runs under ``torch.cuda.set_sync_debug_mode("error")``, before
              its single transfer: it fails if that (prototype) detector
              raises on a sync, and reports that none was raised.
8. determinism -- two identical 2-step runs each of SAGE and GAT (serial
              source) and of SAGE on the device source, papers-s; five calls
              of the edge softmax alone on each backend; two identical
              full-width serve runs (tokens and logits). Each must be bitwise
              equal. Also times what the torch backend's fixed-order softmax
              denominator costs against an ``index_add`` one.
9. serve   -- ``repro_torch.serve``'s path at full width: SmolLM-135M, bf16,
              8 requests of 1024-token prompts, 64 new tokens, greedy.
              Prints prefill ms, decode ms per step (median), tokens/s and
              peak device memory; fails unless the logits are finite and the
              decode kernel launched 30 layers x 63 decode steps times.
10. serve parity -- reduced SmolLM (2 layers, f32) from the same weights:
              prefill and 8 decode steps on the card and on the CPU agree to
              rtol/atol 1e-4 at every step, with equal greedy tokens.
11. faults -- SAGE on ``device_pipelined`` with ``plan_retries=2``: a
              transient fault (twice) and a producer crash must leave the
              losses bitwise equal to phase 7's clean run; a build delayed
              past ``stall_timeout_s`` must raise ``PipelineStallError``
              naming its index; with ``skip_nonfinite`` a poisoned batch must
              leave params and optimizer state bitwise as they were, with
              ``nonfinite_skips == 1``.
12. tracing -- phase 4's pipelined run again with ``obs_trace`` and
              ``obs_path`` under ``build/``: bitwise equal losses, a trace
              that ``validate_trace`` passes, and its stall-class summary.
13. overlap -- the overlap schedule (local/remote edge halves, chunked
              exchange) at phase 4's widths, GAT with 4 heads at hidden 256.
              (a) On the first batch (built with its halves), the overlap
              forward and the gradients of the masked cross-entropy at 1 and
              4 chunks against the blocking ones on the card, for SAGE, GCN
              and GAT: 5e-5 and 3e-4; a bf16 wire at 2 chunks: 5e-2, SAGE
              and GCN (each atol in units of the reference's largest entry,
              see ``scaled_close``; the count outside the unscaled one is
              printed); GAT's bf16 wire error is printed, not held (its
              bf16 scores, see ``overlap_parity``). Each
              model's forward + backward timed by CUDA events, blocking and
              overlap. (b) Each half's gather_segsum kernels at their largest
              launch (the local half over the split's rows, the remote half
              over the recv region, a GAT head chunk of one head), the walk
              included, and the shuffle adjoint at GAT's score width (H=4),
              bitwise against their plain versions on a CPU copy; a
              ``kernel_detail`` line gives their shapes. (c) SAGE with
              overlap at 4 chunks trains 2 epochs of 3 steps on the serial
              and the pipelined source: bitwise equal, and within rtol 1e-4
              of phase 4's blocking losses; GAT with overlap takes 2 steps.
              Each run emits its step ms, peak memory and ``wire_bytes``.
14. cache   -- the same SAGE with the feature cache at 2048 rows a split (a
              quarter of papers-s's 32,768 nodes across P=4). (a) The first
              batch's served block (``sim_serve_features`` over the
              resident block and the staged miss rows) equals the host
              gather, byte for byte on the valid rows, for ``partitioned``
              (no remote hit) and ``distributed`` (some). (b) The
              partitioned cache on the serial and the device_pipelined
              source, 2 epochs of 3 steps: losses bitwise equal to phase 4's
              and phase 7's uncached ones. (c) The hit/miss breakdown, miss
              rows against the input rows, the pinned feature bytes of the
              first batches with and without the cache, the resident block's
              bytes. (d) Overlap at 4 chunks with the partitioned cache on
              the device_pipelined source, bitwise equal to the device
              source. (e) ``profile_step`` in a process of its own over two
              pipelined steps with overlap and the cache: no pageable
              host-to-device copy, two pinned ones a step, and the window's
              device ms and idle share.
15. replication -- hot-vertex replication at 5% of papers-s's rows (1,638
              rows resident, 0.84 MB), phase 4's SAGE widths. (a) The first
              batch built with the set: its shuffle rows fall; forward, loss
              and masked-xent gradients replicated vs unreplicated on the
              card, bitwise for blocking SAGE and GCN, GAT within 2e-5 (loss)
              and 5e-4 (gradients); overlap at 4 chunks with replication
              within 5e-5 / 3e-4 of blocking with replication; the three
              gather_segsum kernels and the walk at every layer of the
              batch (the input layer's rows [local][recv][replicated])
              bitwise against their plain versions on a CPU copy; the
              host time of the four split-quality counters. (b) The serial source, 2 epochs
              of 3 steps: losses bitwise phase 4's, ``wire_bytes`` and
              ``cross_edge_fraction`` lower at every step. (c) device and
              device_pipelined: bitwise equal to each other and to phase
              7's losses. (d) With ``record_telemetry`` on the device
              source: ``refine_partition()`` after epoch 1; the weighted cut
              under the telemetry weights must not rise (printed before and
              after, with the replicated rows and ``cross_edge_fraction``);
              an epoch on the rebuilt sampler launches the wavefront kernel
              its layers times its sampling runs, with finite losses.
16. dp      -- ``mode="dp"`` at phase 4's widths, P = 4 micro-batches of
              256. The first dp batch as the trainer builds it (S = 0, dp's
              larger N): the three gather_segsum kernels and the walk at
              every layer, and ``shuffle_bwd`` at layer 1's self rows,
              bitwise against their plain versions on a CPU copy; the
              trainer's first step loads its rows. Serial, pipelined and
              ``pushpull`` 2 epochs of 3 steps,
              bitwise equal; GCN (no shuffle adjoint at all) and GAT 2 steps;
              ``plan_source="device"`` raises ``ValueError``. Prints the
              loaded rows, computed edges, shuffle rows, load imbalance and
              step ms beside phase 4's split steps.
17. mesh    -- the 2-D (replica, split) mesh in sim form at phase 4's
              widths (P = 4, global batch 1024), 2 epochs of 3 steps a run.
              (a) R = 1 on the serial source: losses bitwise phase 4's.
              (d) Replica 1's first R = 2 batch as the trainer builds it
              (keyed chunks of 512, both parts repadded twice to shared
              marks): the three gather_segsum kernels and the walk, and
              ``shuffle_bwd`` for the send and the self rows, at every
              layer, bitwise against their plain versions on a CPU copy;
              the wavefront expansion at every hop under the replica-keyed
              counter (``batch * R + replica``) bitwise against its plain
              version, and the card's replica-keyed sample bitwise the CPU
              sampler's and the flattened counter's. (b) R = 2 on all four
              sources: serial ≡ pipelined and device ≡ device_pipelined
              bitwise; the device sources launch the wavefront kernel
              their layers times 2 a step; the first step loads the held
              parts' rows. (c) R = 4 x P = 1 (256 targets a replica)
              within rtol 2e-4 / atol 1e-5 of phase 16's dp losses.
              ``mesh_vs_split`` prints losses, step, wait, stage and sync
              ms, loaded and shuffle rows (summed over the parts) and
              memory beside phase 4's and the R = 1 run's. (e) Every run
              line gives each epoch's ``first_iter_ms`` and
              ``steady_step_ms`` (``EpochStats.steady_step_seconds()``).
18. checkpoint -- checkpoint and resume at phase 4's widths, a checkpoint
              every step (``ckpt_every=1``) into a temporary directory, 3
              steps an epoch. (a) On each of the four sources a run killed
              by ``FaultAction("kill", epoch=1, batch=1)`` is resumed by a
              fresh ``Trainer`` at (epoch 1, batch 1) (a device sampler's
              state right after ``resume()`` is the saved one); its steps to
              the end of epoch 2 are bitwise the clean suffix (phase 4's
              serial losses for the host sources, phase 7's for the device
              ones), and on serial and pipelined its final params and Adam
              slots are bitwise phase 4's serial run's. (b) R = 2, serial:
              kill and resume bitwise phase 17's R = 2 losses. (c) GAT (4
              heads), serial, 2 steps an epoch: kill and resume bitwise
              phase 5's GAT losses. (d) The serial run's newest checkpoint
              corrupted (``corrupt_checkpoint``): ``resume()`` falls back to
              the one before, and its one step and final state are still
              phase 4's; every checkpoint truncated: ``resume()`` raises
              ``CheckpointError``. (e) ``checkpoint`` prints the card, the
              ``params.npz`` bytes, each save's ms (median, max) and one
              save's parts (D2H, ``np.savez``, sha256, write + fsync), each
              resume's ms, the runs' step ms, the phase's wall and launches,
              and ``presample`` seconds at
              ``presample_workers`` 1 and 4 on papers-s (2 epochs): the two
              weight vectors differ (other streams) and 4 workers repeat
              bitwise.
19. spmd    -- the spmd form of split parallelism over torch.distributed
              (``repro_torch.launch``): one rank spawned by
              ``spmd.launch`` on the card at world size 1, NCCL, a
              ``FileStore`` rendezvous (an NCCL failure fails the phase).
              (a) ``spmd_alltoall`` at a full-width block (8192 x 256, fp32
              and a bf16 wire) bitwise ``sim_alltoall``, forward and
              adjoint, and ``replica_grad_mean`` at R = 1 the identity.
              (b) ``SpmdTrainer`` (``train_rank``), SAGE and GAT (4 heads)
              at phase 4's widths and fan-outs with ``num_devices=1``, 3
              steps: losses bitwise the sim ``Trainer``'s at
              ``num_devices=1`` (one split sends nothing, S = 0; the
              gradient and loss all-reduces run over NCCL); the rank's
              launch counts (gss_fwd, the row adjoint and its walk,
              gss_bwd_w for GAT, shuffle_bwd at the self rows) are checked
              as a step's and printed, with its step ms beside the sim
              step's. (c) ``sample_minibatch_spmd`` on the first batch's
              targets at P = 1, bitwise the device sampler's loop, with
              one ``wavefront_expand`` launch a hop. (d) A rehearsal on
              the CPU, labelled ``"device": "cpu"``: four gloo ranks,
              SAGE at P = 4 and GAT on the 2 x 2 (replica, split) mesh,
              3 steps on the tiny graph, within rtol 1e-4 of the port's
              sim ``Trainer``, every rank with the same losses.
20. families -- the five other transformer families on the serve path at
              full width, bf16 weights seeded on the card, B = 8, 1024
              prompt rows (LLaVA: 576 patch rows + 448 tokens), 16 new
              tokens: DeepSeek-V2-Lite-16B (27 layers, MoE + MLA),
              Mamba2-2.7B, Hymba-1.5B (its 1024-row ring wraps),
              MusicGen-medium (4 codebooks), LLaVA-NeXT-Mistral-7B and
              DeepSeek-V2-236B cut to 2 layers (its line names the cut),
              one at a time. Two runs bitwise equal, finite logits, the
              decode kernel launched (attention layers) x 15 times (0 for
              Mamba2), prefill ms, decode median, tokens/s, peak memory;
              DeepSeek-V2-Lite also with ``opt_mla_absorb`` (no launch; its
              logit difference printed); each reduced config card vs CPU
              within 1e-4 over 8 decode steps with equal tokens.
21. lm-train -- the transformer train step (``make_train_step``: train
              mode, ``lm_loss``, per-layer remat, ``adamw(1e-3)``) at full
              width, bf16 weights seeded on the card, one seeded batch of
              4096 rows a sequence, one config at a time: SmolLM-135M,
              DeepSeek-V2-Lite-16B cut to 6 layers, DeepSeek-V2-236B cut to
              2, Mamba2-2.7B, Hymba-1.5B, MusicGen-medium (B = 2) and
              LLaVA-NeXT-Mistral-7B (B = 1, 576 patch rows + 3520 tokens);
              each line names its cut. Two runs of 4 steps from one seed,
              bitwise equal losses and final weights; finite losses, step
              4's below step 1's; no kernel launch (the train path runs
              none); median step ms over steps 2-4, tokens/s, the
              roofline of ``train_4k`` at this batch from
              ``launch/roofline.py`` (``flops`` counted on the meta device,
              no second run; the least ``bytes_accessed``; the three terms,
              ``model_flops`` = 6 x active parameters x tokens, the share
              of the step, at most 1.05), ``mfu`` against 989 TFLOP/s, the
              peak over the phase's baseline.
              SmolLM at B = 1, S = 2048 with ``opt_remat`` "full" and
              "none": loss and gradients bitwise, both peaks printed. Each
              family's reduced config (SmolLM at S = 2048, through
              ``attention_flash``'s backward), one train step card vs CPU:
              loss, aux, every gradient and the updated weights within
              1e-4 (a weight whose CPU gradient is roundoff, at most 1e-5
              of its leaf's largest entry, within 2 lr: Adam's normalised
              step turns either sign of roundoff into lr; counted).
22. shapes -- the reference's input shapes (``launch/input_specs.py``) on
              the card through ``launch/shapes.py::run_one``, for each of
              the ten configs (DeepSeek-V2-236B at 2 layers,
              ``SHAPE_LAYERS``): prefill_32k
              (B = 1, 32768 rows; ``SHAPE_PREFILL_LAYERS`` cuts the depth
              of the configs whose plain flash loop would not fit the
              phase's time), decode_32k (one card's batch, ``card_batch``,
              against seeded 32768-row caches at positions 32761-32767)
              and long_500k (B = 1, full attention windowed at 8192 rows,
              positions 524281-524287). One line a record: batch and cuts,
              step seconds, flops, least bytes, the three terms, the
              roofline share, ``mfu``, peak memory beside ``card_bytes``'
              estimate. Checks: finite logits;
              the decode kernel launched (attention layers) x 7 steps in a
              decode run and never in a prefill; at layer 0 of each decode
              cache the kernel, launched once on the whole batch as the
              step launches it, within ``decode_attention_bound`` (MLA's
              whole latent cache expanded); every share at most 1.05.
23. entry points -- ``repro_torch.train_gnn_e2e.main`` at 40 steps
              (orkut-s, SAGE, split beside dp) on the serial source and
              with ``--plan-source pipelined``: its two asserts hold (the
              loss falls; dp loads more rows), and the forward, the row
              adjoint and the shuffle adjoint launched.
24. tp     -- the transformer across ranks on the serve path: Granite-20B
              (MQA, its k/v sharded by sequence) and DeepSeek-V2-Lite-16B
              (MLA latents sharded by sequence, experts sharded) at full
              width cut to 2 layers, 8 prompts of 1024 rows, 8 decode
              steps: the unsharded f32 run; the (1, 1) mesh over NCCL at
              world size 1 (a process group of this process) bitwise it;
              the (1, 2) mesh of two ranks sharing ``cuda:0`` over gloo
              (every collective through the host), f32 logits within 1e-4
              of the unsharded run with equal tokens, each rank's
              parameters and caches its specs' slices, the decode kernel's
              partial output launched (attention layers) x 8 times a rank
              and its whole output never, each rank's collectives (calls
              and result bytes by axis and kind) and peak, and its build
              of the weights one leaf at a time (its peak then within its
              slices and one leaf); bf16 tokens and ms a step, printed;
              then f32 again with the allocator's history on: what is
              alive at a rank's peak (``obs/memory.py``).
25. tp-train -- the transformer train step across ranks, and Mamba2 and
              Hymba on a model axis: Granite-20B, DeepSeek-V2-Lite-16B,
              Mamba2-2.7B and Hymba-1.5B at full width cut to 2 layers,
              B = 2 sequences of 1024 rows, 2 ``adamw(1e-3)`` steps
              (``launch/shapes.py::train_rank``). (a) bf16: the (1, 1)
              mesh over NCCL at world size 1, its losses and every weight
              after the steps bitwise the unsharded train step's. (b) f32:
              two ranks sharing ``cuda:0`` over gloo as the (1, 2) mesh,
              the first step's loss within 1e-5 (relative) of the
              unsharded run's, the second's within 1e-4,
              each rank's first-step gradient slices within 1e-4 of the
              leaf's max abs gradient, each weight slice after the steps
              within 1e-4 of the leaf's max abs but for Adam's
              noise-sensitive entries (within 2 lr a step; counted, with
              their first-step |g| over the leaf's max), the replicated
              leaves bitwise equal across the ranks, the same collectives
              on both ranks and in both steps (calls and result bytes by
              axis and kind), peak bytes and step ms a rank. (c) Mamba2 and Hymba served on the same
              two ranks, f32, 2 prompts of 1024 rows and 8 decode steps:
              logits within 1e-4 of the unsharded run's, equal tokens, the
              SSM state sharded by head, Hymba's ring sharded by sequence
              (the decode kernel's partial output, 2 x 8 launches a rank).

Launch counts are set to 0 just before each trainer run, each serve run,
each transformer train run, each shape run and the entry point's run and
read just after (phases 19's and 24's ranks' in their own processes; the
decode kernel's row counts phase 24's partial-output launches too, and
gives them apart as ``partial_launches``; phase 21's must all
read 0; phase 22's layer-0 checks are taken back out); a kernel of
the run's path that was never launched fails the script, and so does a trainer run whose row-adjoint launches
differ from its walk builds (``src_sorted_csr``, reported as the row
adjoint's ``csr_builds``) or whose shuffle-adjoint launches differ from its
steps times the gathers a step differentiates, by mode and model
(``SHUFFLE_BWD_PER_STEP``; ``SHUFFLE_BWD_OVERLAP`` under the overlap
schedule: a dp step sends nothing, so only its self rows count), times R
for a mesh step, whose P = 1 parts send nothing either. The packed segment kernels run on no trainer path
(``segment_ops``'s packed backend, which the model does not call): their
counts come from one call of ``segment_ops.segment_sum``/``edge_softmax``
with ``backend="packed"``, driven with the counts at 0. The last lines are
the ``kernels`` JSON, the nvidia-smi line and the result line.
"""
import contextlib
import copy
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's constants (H100 SXM, NVIDIA's data sheet, 700 W) and the kernel
# bound: one home, ``launch/roofline.py``, which the roofline records read too
from repro_torch.launch import roofline  # noqa: E402

FWD_TOL = dict(rtol=3e-5, atol=3e-5)
ADJ_TOL = dict(rtol=3e-4, atol=3e-4)
PACKED_TOL = dict(rtol=3e-5, atol=3e-5)
CSRC = "src/repro_torch/csrc/"
#: kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "gather_segsum_fwd": ("gather_segsum.cu",
                          "src/repro/kernels/gather_segsum/kernel.py:190"),
    "gather_segsum_bwd_mixed": ("gather_segsum.cu",
                                "src/repro/kernels/gather_segsum/kernel.py:240"),
    "gather_segsum_bwd_w": ("gather_segsum.cu",
                            "src/repro/kernels/gather_segsum/kernel.py:293"),
    "wavefront_expand": ("wavefront_expand.cu", "src/repro/sampler/kernel.py:43"),
    "segment_sum_packed": ("segsum_packed.cu",
                           "src/repro/kernels/segsum/kernel.py:44"),
    "edge_softmax_packed": ("edge_softmax_packed.cu",
                            "src/repro/kernels/edge_softmax/kernel.py:61"),
    "flash_decode": ("flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:61"),
    # no Pallas kernel: the JAX package leaves this adjoint to XLA
    "shuffle_bwd": ("shuffle_bwd.cu",
                    "none: XLA's scatter-add, the adjoint of the gather at "
                    "src/repro/core/shuffle.py:160"),
}
LIBRARIES = ("gather_segsum", "wavefront_expand", "segsum_packed",
             "edge_softmax_packed", "flash_decode", "shuffle_bwd")
FANOUTS = (15, 15, 15)
L = len(FANOUTS)
#: ``shuffle_bwd`` launches a training step makes, by mode and model. Split:
#: the shuffle's, one a layer but the input layer's (its rows take no
#: gradient), and the self rows' (SAGE: likewise; GAT: every layer, whose
#: weighted rows take one); replication changes none. dp and pushpull send
#: nothing (S = 0: ``sim_shuffle`` returns its rows), so only the self rows'
#: remain: SAGE L-1, GAT L, GCN none.
SHUFFLE_BWD_PER_STEP = {
    "split": {"sage": 2 * (L - 1), "gcn": L - 1, "gat": 2 * L - 1},
    "dp": {"sage": L - 1, "gcn": 0, "gat": L},
}
SHUFFLE_BWD_PER_STEP["pushpull"] = SHUFFLE_BWD_PER_STEP["dp"]
#: under the overlap schedule split GAT sends transformed rows (w takes a
#: gradient at every layer) and its a_src scores: send, scores and self rows
#: at every layer, one launch each, whatever the chunks (autograd's slice
#: adjoint sums the chunks' cotangents); SAGE and GCN launch as blocking, and
#: so does every model in dp (nothing is sent)
SHUFFLE_BWD_OVERLAP = {**SHUFFLE_BWD_PER_STEP,
                       "split": {**SHUFFLE_BWD_PER_STEP["split"], "gat": 3 * L}}
OVERLAP_TOL = dict(rtol=5e-5, atol=5e-5)
WIRE_TOL = dict(rtol=5e-2, atol=5e-2)
CACHE_ROWS = 2048  # a quarter of papers-s's 32,768 nodes across P=4
REP_BUDGET = 0.05  # replicated rows: 5% of papers-s's nodes (1,638)
GAT_REP_TOL = dict(rtol=5e-4, atol=5e-4)  # GAT, replicated vs not: grads
#: an R x 1 mesh against dp: R per-replica means against one joint mean
MESH_DP_TOL = dict(rtol=2e-4, atol=1e-5)
#: each trainer run's (resident_bytes, peak_bytes), by run name
MEMORY = {}
#: the card's nvidia-smi name and power limit (phase 1), printed beside
#: phase 18's host-clock numbers
CARD = None


def counters():
    """The wrappers' launch-count modules (each has ``LAUNCHES`` and
    ``reset_launches``)."""
    # segment_ops first: it imports the packed ops' modules in an order
    # that resolves their imports of one another
    from repro_torch.kernels import segment_ops  # noqa: F401
    from repro_torch.kernels.edge_softmax import ops as es_ops
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.gather_segsum import kernel as gss
    from repro_torch.kernels.segsum import ops as ss_ops
    from repro_torch.kernels.shuffle import kernel as sh
    from repro_torch.sampler import kernel as wf

    return (gss, wf, ss_ops, es_ops, fd, sh)


def reset_launches():
    for mod in counters():
        mod.reset_launches()


def read_launches():
    out = {}
    for mod in counters():
        out.update(mod.LAUNCHES)
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(tag, obj):
    print(json.dumps({tag: obj}), flush=True)


def time_ms(fn, iters=30, warmup=5, flush=None):
    """Median device time of ``fn`` over ``iters`` launches (CUDA events).
    ``flush``, a tensor larger than the 50 MB L2, is overwritten before each
    launch, outside the timed interval, so ``fn`` finds its inputs cold."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def profiled(body, iters):
    """The profiler's rows of what ``iters`` calls of ``body`` ran on the
    card, after one call outside the window. The profiler now and then drops
    a window's kernels (none, or 19 of 20 launches seen): each kernel must
    show a whole number of launches a call, or the window is taken again. An
    empty window first takes in any records that arrive late from the one
    before."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(5):
        body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                body()
            torch.cuda.synchronize()
        ran = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ran and all(e.count % iters == 0 for e in ran):
            return ran
        seen.append({e.key[:60]: e.count for e in ran})
    check(False, f"the profiler lost launches in five windows running: {seen}")


def device_ms(fn, iters=20, flush=None):
    """Device time of one ``fn`` call from ``torch.profiler``: the own time
    of every kernel and copy on the card over ``iters`` calls, per call,
    less what the ``flush`` alone takes. Unlike ``time_ms`` it leaves out
    the host's time to launch, which a short kernel can be bound by."""

    def per_call(body):
        ran = profiled(body, iters)
        return sum(e.self_device_time_total for e in ran) / 1e3 / iters

    if flush is None:
        return per_call(fn)
    return per_call(lambda: (flush.zero_(), fn())) - per_call(flush.zero_)


def device_kernels(fn, calls=5):
    """What one ``fn`` call runs on the card, by the profiler over ``calls``
    calls: each kernel and copy's name (cut to 90 characters) and how many
    times a call it ran. Fails if five windows running each saw nothing on
    the card or lost launches."""
    return {e.key[:90]: e.count / calls for e in profiled(fn, calls)}


def host_ms(fn, calls=100, repeats=3):
    """A wrapper's host time per call: a host clock over ``calls`` enqueued
    calls, no sync inside the loop (after a warm-up call and a sync); the
    median of ``repeats`` such loops."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times) / calls


def papers_first_batch(seed=0):
    """The first batch of papers-s as the trainer builds it (P=4, fan-outs
    15,15,15, batch 1024, presample cut to 2 epochs): the dataset, the
    partition, the host sampler, the batch's targets and its repadded plan,
    with its edge halves."""
    from repro_torch.core import build_split_plan, partition_graph, presample, repad_plan
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.graph.sampling import NeighborSampler

    ds = make_dataset("papers-s")
    fan = list(FANOUTS)
    w = presample(ds.graph, ds.train_ids, fan, 1024, num_epochs=2, seed=seed + 1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w, seed=seed)
    sampler = NeighborSampler(ds.graph, ds.train_ids, fan, 1024, seed=seed)
    targets = sampler.epoch_targets(0)[0]
    # with the overlap schedule's edge halves (phase 13); the blocking
    # kernels of phase 3 do not read them
    plan = build_split_plan(sampler.sample_batch(targets, 0, 0),
                            part.assignment, 4, pad_multiple=-1, with_halves=True)
    return SimpleNamespace(ds=ds, weights=w, part=part, sampler=sampler,
                           targets=targets, plan=repad_plan(plan, {}))


def layer_pack(lp, P, dev):
    """One layer's pack on the card, and what the bounds and the library
    calls need: its valid slots as the (dst, src) entries of one
    block-diagonal (P*num_out x P*M) matrix, and the distinct rows they
    touch."""
    import torch

    from repro_torch.kernels.gather_segsum import ops
    from repro_torch.kernels.gather_segsum.layout import AGG_ROWS as R

    num_out = lp.self_pos.shape[1]
    M = lp.n_local + P * lp.send_idx.shape[2]
    _, DB, EB = lp.pack_dst.shape
    pack_dst = torch.as_tensor(lp.pack_dst, device=dev)
    pack_src = ops._pack_src(torch.as_tensor(lp.edge_src, device=dev),
                             torch.as_tensor(lp.pack_perm, device=dev), pack_dst, M)
    valid = (pack_dst < R).reshape(P, -1)
    n_valid = int(valid.sum())
    split = torch.arange(P, device=dev)[:, None]
    db = (torch.arange(DB * EB, device=dev) // EB)[None]
    flat_src = (split * M + pack_src.reshape(P, -1))[valid]
    flat_dst = (split * num_out + db * R + pack_dst.reshape(P, -1))[valid]
    adj = torch.sparse_coo_tensor(
        torch.stack([flat_dst, flat_src]), torch.ones(n_valid, device=dev),
        (P * num_out, P * M),
    ).coalesce()
    src_runs = torch.bincount(flat_src, minlength=P * M)
    dst_runs = torch.bincount(flat_dst, minlength=P * num_out)
    return SimpleNamespace(
        P=P, M=M, num_out=num_out, DB=DB, EB=EB, pack_src=pack_src,
        pack_dst=pack_dst, valid=valid, n_valid=n_valid,
        slot_key=flat_dst * (P * M) + flat_src,
        src_rows=int((src_runs > 0).sum()),
        longest_src_run=int(src_runs.max()),
        src_runs_over_32=int((src_runs > 32).sum()),
        dst_rows=int(torch.unique(flat_dst).numel()),
        longest_dst_run=int(dst_runs.max()) if n_valid else 0,
        # pack_dst is read in full, pack_src only at the valid slots
        index_bytes=4 * (P * DB * EB + n_valid),
        adj=adj, adj_csr=adj.to_sparse_csr(),
        adj_t_csr=adj.t().coalesce().to_sparse_csr(),
    )


def record(results, name, out, want, fn, plain, library, nbytes, nops,
           tol=None, rate=roofline.FP32_FLOPS, shape=None, flush=None,
           extra=None):
    """Hold a kernel's output against its plain version's (``tol``: the
    rtol/atol of ``assert_close``, an elementwise bound tensor, or None for
    bitwise), check that a second launch repeats it bit for bit,
    time the kernel, its plain version and the library call by CUDA events
    (``ms``, which include the host's time to launch a short kernel), the
    kernel and the library call by the profiler's device time
    (``device_ms``, ``library_device_ms``: the comparison that rule 2
    reads), the wrapper's host time per call (``host_ms``), and keep the
    row of the ``kernels`` line. A row with a ``shape`` label is emitted and
    not kept: the ``kernels`` line holds each kernel at its main path's
    shape."""
    import torch

    if tol is None:
        check(torch.equal(out, want), f"{name}: differs from its plain version")
        err = 0.0
    else:
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        if isinstance(tol, torch.Tensor):
            check(bool((diff <= tol).all()), f"{name}: max error {err} outside the bound")
        else:
            torch.testing.assert_close(out, want, **tol)
    check(torch.equal(out, fn()), f"{name}: two launches differ")
    bound_ms, bound_by = roofline.kernel_bound(nbytes, nops, rate)
    source, replaces = KERNELS[name]
    host = host_ms(fn)  # first: no profiler has run on this kernel yet
    row = dict(
        name=name, route="cuda", source=CSRC + source, replaces=replaces,
        launches=0, max_abs_err=err, ms=time_ms(fn, flush=flush),
        plain_ms=time_ms(plain, flush=flush), bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=time_ms(library, flush=flush) if library is not None else None,
        device_ms=device_ms(fn, flush=flush),
        library_device_ms=(device_ms(library, flush=flush)
                           if library is not None else None),
        host_ms=host,
    )
    line = {k: v for k, v in row.items() if k != "launches"}
    if shape is None:
        results[name] = row
    else:
        line["shape"] = shape
    emit("kernel", {**line, **(extra or {})})


def kernel_phase(dev, first, results):
    """Phase 3, the gather_segsum kernels, each against its plain version at
    the shapes the main path gives it. The input layer (F=128 rows, no
    gradient) is SAGE's and GCN's largest forward; its rows get a gradient
    only under GAT (F=256 = 4 heads x 64), so the unweighted row adjoint is
    held and timed at layer 1 (F=256), the largest shape where SAGE and GCN
    launch it. The forward and the row adjoint sum in the order the plain
    versions' ``index_add_`` sums on a CPU tensor, so they are held to a CPU
    copy's result bit for bit."""
    import torch

    from repro_torch.kernels.gather_segsum import kernel, ref

    plan = first.plan
    P = plan.num_devices
    inp = layer_pack(plan.layers[-1], P, dev)
    hid = layer_pack(plan.layers[1], P, dev)
    emit("kernel_shapes", {
        name: dict(P=P, M=lay.M, num_out=lay.num_out, DB=lay.DB, EB=lay.EB,
                   slots=P * lay.DB * lay.EB, valid_slots=lay.n_valid,
                   src_rows=lay.src_rows, dst_rows=lay.dst_rows,
                   longest_src_run=lay.longest_src_run,
                   src_runs_over_32=lay.src_runs_over_32)
        for name, lay in (("input_layer", inp), ("layer_1", hid))
    })
    gen = torch.Generator(device=dev).manual_seed(0)

    def csr_for(lay, layer):
        """The row adjoint's src-ordered walk: built, held bitwise against
        its plain version on a CPU copy, and timed (events, device, host)
        with the kernels one build runs."""
        build = lambda: kernel.src_sorted_csr(  # noqa: E731
            lay.pack_src, lay.pack_dst, lay.M, lay.num_out)
        csr = build()
        want = kernel.src_sorted_csr(lay.pack_src.cpu(), lay.pack_dst.cpu(),
                                     lay.M, lay.num_out)
        for name, a, b in zip(("offsets", "sorted_grow", "sorted_slot"), csr, want):
            check(torch.equal(a.cpu(), b), f"src_sorted_csr layer {layer}: {name} "
                                           "differs from its plain version")
        info = {"layer": layer, "host_ms": host_ms(build), "ms": time_ms(build),
                "device_ms": device_ms(build), "kernels": device_kernels(build),
                "bitwise_vs_cpu": True}
        info["launches"] = sum(info["kernels"].values())
        emit("src_sorted_csr", info)
        return csr, info

    def on_cpu(fn, *args):
        """``fn`` (a plain version) on CPU copies of ``args``, back on the
        card: ``index_add_`` on a CPU tensor adds in index order, the order
        the kernels sum in, so the kernels are held to it bit for bit."""
        return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args)).to(dev)

    def weighted_check(name, out, want, tol):
        """GAT's weighted kernels: bitwise against the plain version on a
        CPU copy (the kernels round each product as the plain version's
        elementwise product does), and within ``tol`` besides."""
        torch.testing.assert_close(out, want, **tol)
        check(torch.equal(out, want), f"{name}: differs from its plain version "
                                      "on a CPU copy")
        emit("kernel_check", {"name": name, "bitwise_vs_cpu": True,
                              "max_abs_err": 0.0})

    # forward at SAGE's input-layer width (F = 128)
    F = 128
    mixed = torch.randn(P, inp.M, F, device=dev, generator=gen)
    args = (mixed, inp.pack_src, inp.pack_dst, None, inp.num_out)
    fwd = lambda: kernel.gather_segsum_fwd(*args)  # noqa: E731
    plain = lambda: ref.gather_segsum_fwd_packed(*args)  # noqa: E731
    flat_mixed = mixed.reshape(P * inp.M, F)
    library = lambda: torch.sparse.mm(inp.adj_csr, flat_mixed)  # noqa: E731
    out = fwd()
    torch.testing.assert_close(library().reshape(P, inp.num_out, F), out, **FWD_TOL)
    record(results, "gather_segsum_fwd", out,
           on_cpu(ref.gather_segsum_fwd_packed, *args), fwd, plain, library,
           inp.index_bytes + 4 * F * (inp.src_rows + P * inp.num_out),
           inp.n_valid * F)
    ran = device_kernels(fwd)
    emit("kernel_detail", {"name": "gather_segsum_fwd", "kernels": ran,
                           "bitwise_vs_cpu": True})
    check(not any("searchsorted" in k.lower() for k in ran),
          f"gather_segsum_fwd launches a searchsorted: {ran}")

    # GAT's weighted forward at the input layer (F = 256 = 4 x 64): checked
    H, Fw = 4, 256
    mixed_w = torch.randn(P, inp.M, Fw, device=dev, generator=gen)
    w = torch.randn(P, inp.DB * inp.EB, H, device=dev, generator=gen)
    args_w = (mixed_w, inp.pack_src, inp.pack_dst, w, inp.num_out)
    out_w = kernel.gather_segsum_fwd(*args_w)
    check(torch.equal(out_w, kernel.gather_segsum_fwd(*args_w)),
          "gather_segsum_fwd (weighted): two launches differ")
    weighted_check("gather_segsum_fwd (weighted, input layer, H=4, F=256)", out_w,
                   on_cpu(ref.gather_segsum_fwd_packed, *args_w), FWD_TOL)

    # adjoint w.r.t. the rows, unweighted, at layer 1 (F = 256): SAGE and GCN.
    # The kernel row times the kernel on a prebuilt walk; the walk's build and
    # the whole (build + kernel, as the backward runs it) are reported beside
    g = torch.randn(P, hid.num_out, Fw, device=dev, generator=gen)
    csr, walk = csr_for(hid, 1)
    args = (g, hid.pack_src, hid.pack_dst, None, hid.M)
    bwd = lambda: kernel.gather_segsum_bwd_mixed(*args, csr)  # noqa: E731
    whole = lambda: kernel.gather_segsum_bwd_mixed(*args)  # noqa: E731
    plain = lambda: ref.gather_segsum_bwd_mixed_packed(*args)  # noqa: E731
    flat_g = g.reshape(P * hid.num_out, Fw)
    library = lambda: torch.sparse.mm(hid.adj_t_csr, flat_g)  # noqa: E731
    out = bwd()
    torch.testing.assert_close(library().reshape(P, hid.M, Fw), out, **ADJ_TOL)
    check(torch.equal(out, whole()), "gather_segsum_bwd_mixed: the walk built "
                                     "inside the call gives another result")
    record(results, "gather_segsum_bwd_mixed", out,
           on_cpu(ref.gather_segsum_bwd_mixed_packed, *args), bwd, plain, library,
           hid.index_bytes + 4 * Fw * (hid.dst_rows + P * hid.M),
           hid.n_valid * Fw)
    detail = {"csr_ms": walk["ms"], "csr_device_ms": walk["device_ms"],
              "csr_host_ms": walk["host_ms"], "csr_launches": walk["launches"],
              "whole_host_ms": host_ms(whole), "whole_ms": time_ms(whole),
              "whole_device_ms": device_ms(whole)}
    results["gather_segsum_bwd_mixed"].update(detail)
    emit("kernel_detail", {"name": "gather_segsum_bwd_mixed", **detail,
                           "kernels": device_kernels(bwd),
                           "whole_kernels": device_kernels(whole),
                           "bitwise_vs_cpu": True})

    # GAT's weighted row adjoint at the input layer: checked
    g_w = torch.randn(P, inp.num_out, Fw, device=dev, generator=gen)
    csr_w, _ = csr_for(inp, len(plan.layers) - 1)
    args_w = (g_w, inp.pack_src, inp.pack_dst, w, inp.M)
    gm_w = kernel.gather_segsum_bwd_mixed(*args_w, csr_w)
    check(torch.equal(gm_w, kernel.gather_segsum_bwd_mixed(*args_w)),
          "gather_segsum_bwd_mixed (weighted): two launches differ")
    weighted_check("gather_segsum_bwd_mixed (weighted, input layer, H=4, F=256)",
                   gm_w, on_cpu(ref.gather_segsum_bwd_mixed_packed, *args_w), ADJ_TOL)

    # adjoint w.r.t. GAT's per-slot weights at the input layer, bitwise
    # against its plain version on a CPU copy; the library call is an SDDMM
    # over the plan's (dst, src) pattern, heads as the batch
    emit("kernel_shapes", {"gather_segsum_bwd_w": dict(
        P=P, DB=inp.DB, EB=inp.EB, H=H, F=Fw, slots=P * inp.DB * inp.EB,
        valid_slots=inp.n_valid, dst_rows=inp.dst_rows,
        longest_run=inp.longest_dst_run)})
    args = (mixed_w, g_w, inp.pack_src, inp.pack_dst, H)
    bw = lambda: kernel.gather_segsum_bwd_w(*args)  # noqa: E731
    plain = lambda: ref.gather_segsum_bwd_w_packed(*args)  # noqa: E731
    rows, cols, nnz = P * inp.num_out, P * inp.M, inp.adj._nnz()
    pattern = torch.sparse_csr_tensor(
        inp.adj_csr.crow_indices().expand(H, -1).contiguous(),
        inp.adj_csr.col_indices().expand(H, -1).contiguous(),
        torch.zeros(H, nnz, device=dev), (H, rows, cols),
    )
    g_heads = g_w.reshape(rows, H, Fw // H).transpose(0, 1).contiguous()
    mixed_heads_t = mixed_w.reshape(cols, H, Fw // H).permute(1, 2, 0).contiguous()
    library = lambda: torch.sparse.sampled_addmm(  # noqa: E731
        pattern, g_heads, mixed_heads_t, beta=0.0)
    keys = inp.adj.indices()[0] * cols + inp.adj.indices()[1]
    at_slot = torch.searchsorted(keys, inp.slot_key)
    out = bw()
    torch.testing.assert_close(library().values()[:, at_slot].T,
                               out.reshape(P, -1, H)[inp.valid], **ADJ_TOL)
    record(results, "gather_segsum_bwd_w", out,
           on_cpu(ref.gather_segsum_bwd_w_packed, *args), bw, plain, library,
           inp.index_bytes + 4 * Fw * (inp.src_rows + inp.dst_rows)
           + 4 * P * inp.DB * inp.EB * H, 2 * inp.n_valid * Fw)


def wavefront_phase(dev, first, results):
    """Phase 3, the wavefront expansion at the device sampler's largest
    launch of the first papers-s batch: the frontier of the largest cap,
    P*N rows x fan-out 15, bitwise against its plain version. There is no
    library call for it. Bound: the larger of the bytes (vid and deg read,
    the codes written) and the integer work of the valid rows (about 28
    ops a slot for the three hash rounds, the reduction and the selects,
    plus a compare per earlier slot for the dedup) at the INT32 rate."""
    from repro_torch.sampler import DeviceSampler
    from repro_torch.sampler import kernel as wf
    from repro_torch.sampler import ref
    from repro_torch.sampler.engine import _sample_device, frontier_degrees

    eng = DeviceSampler(first.ds.graph, first.part.assignment, 4, FANOUTS, 0,
                        host_sampler=first.sampler, device=dev)
    t_dev, keys = eng.device_inputs(first.targets, 0, 0)
    fronts, counts, _, _ = _sample_device(
        eng._dev, t_dev, len(first.targets), keys, caps=eng.caps_tuple(),
        fanouts=FANOUTS,
    )
    layer = max(range(len(FANOUTS)), key=lambda l: fronts[l].numel())
    _, _, deg = frontier_degrees(eng._dev, fronts[layer], counts[layer])
    vid, deg, key = fronts[layer].reshape(-1), deg.reshape(-1), keys[layer]
    fanout = FANOUTS[layer]
    rows, valid_rows = vid.numel(), int((deg >= 0).sum())
    emit("kernel_shapes", {"wavefront_expand": dict(
        layer=layer, rows=rows, valid_rows=valid_rows, fanout=fanout,
        caps=dict(eng.caps_tuple()))})
    fn = lambda: wf.wavefront_expand(vid, deg, key, fanout)  # noqa: E731
    plain = lambda: ref.expand_codes(vid, deg, key[0], key[1], fanout)  # noqa: E731
    ops = valid_rows * fanout * (28 + (fanout - 1) / 2)
    record(results, "wavefront_expand", fn(), plain(), fn, plain, None,
           8 * rows + 16 + 4 * fanout * rows, ops, rate=roofline.INT32_OPS)
    # the launch floor: an empty kernel on the same grid, timed the same ways
    floor = lambda: wf.launch_floor(rows, fanout, dev)  # noqa: E731
    detail = {"floor_ms": time_ms(floor), "floor_device_ms": device_ms(floor),
              "floor_host_ms": host_ms(floor)}
    results["wavefront_expand"].update(detail)
    emit("kernel_detail", {"name": "wavefront_expand", **detail,
                           "kernels": device_kernels(fn)})


def shuffle_phase(dev, first, results):
    """Phase 3, the shuffle adjoint at layer 1 of the first papers-s batch,
    the widest shuffle a gradient flows through (the input layer's rows take
    none), at the hidden width (F=256, GAT's four heads of 64 and SAGE's
    hidden layer alike). The cotangent is zero at the padding slots, as on
    the path. Bitwise against its plain version on a CPU copy; the library
    call is torch's own adjoint of the gather (``index_put_`` with
    accumulate, every padding slot walked), within 1e-6. Bound: bytes (the
    output written once, the valid cotangent rows and their indices read
    once)."""
    import torch

    from repro_torch.kernels.shuffle import kernel as sh
    from repro_torch.kernels.shuffle import ref

    lp = first.plan.layers[1]
    P, _, S = lp.send_idx.shape
    N, F = lp.n_local, 256
    idx = torch.as_tensor(lp.send_idx, device=dev)
    count = torch.as_tensor(lp.send_count, device=dev)
    n_valid = int(lp.send_count.sum())
    emit("kernel_shapes", {"shuffle_bwd": dict(
        layer=1, P=P, N=N, S=S, F=F, slots=P * P * S, valid_slots=n_valid,
        row0_padding_slots=[int(P * S - lp.send_count[q].sum()) for q in range(P)])})
    gen = torch.Generator(device=dev).manual_seed(5)
    valid = torch.arange(S, device=dev)[None, None, :] < count[:, :, None]
    g = torch.randn(P, P, S, F, device=dev, generator=gen) * valid[..., None]
    fn = lambda: sh.shuffle_bwd(g, idx, count, N)  # noqa: E731
    plain = lambda: ref.shuffle_bwd(g, idx, count, N)  # noqa: E731
    owner = torch.arange(P, device=dev)[:, None, None].expand(P, P, S)
    rows = idx.long()
    library = lambda: torch.zeros(P, N, F, device=dev).index_put_(  # noqa: E731
        (owner, rows), g, accumulate=True)
    out = fn()
    torch.testing.assert_close(library(), out, rtol=1e-6, atol=1e-6)
    record(results, "shuffle_bwd", out,
           ref.shuffle_bwd(g.cpu(), idx.cpu(), count.cpu(), N).to(dev), fn, plain,
           library, 4 * P * N * F + 4 * n_valid * (F + 1) + 4 * P * P, n_valid * F)
    ran, lib_ran = device_kernels(fn), device_kernels(library)
    emit("kernel_detail", {"name": "shuffle_bwd", "kernels": ran,
                           "library_kernels": lib_ran, "bitwise_vs_cpu": True})
    check(not any("indexing_backward" in k for k in ran),
          f"shuffle_bwd runs torch's indexing adjoint: {ran}")

    # the self rows' adjoint at layer 1: one group, the split's destinations
    M = N + P * S
    self_pos = torch.as_tensor(lp.self_pos, device=dev)[:, None, :].contiguous()
    dst_count = torch.as_tensor(first.plan.node_count[1], device=dev)[:, None].contiguous()
    n_dst = self_pos.shape[2]
    live = torch.arange(n_dst, device=dev)[None, None, :] < dst_count[:, :, None]
    g1 = torch.randn(P, 1, n_dst, F, device=dev, generator=gen) * live[..., None]
    fn = lambda: sh.shuffle_bwd(g1, self_pos, dst_count, M)  # noqa: E731
    plain = lambda: ref.shuffle_bwd(g1, self_pos, dst_count, M)  # noqa: E731
    owner1 = torch.arange(P, device=dev)[:, None, None].expand_as(self_pos)
    rows1 = self_pos.long()
    library = lambda: torch.zeros(P, M, F, device=dev).index_put_(  # noqa: E731
        (owner1, rows1), g1, accumulate=True)
    out = fn()
    torch.testing.assert_close(library(), out, rtol=1e-6, atol=1e-6)
    n_live = int(first.plan.node_count[1].sum())
    record(results, "shuffle_bwd", out,
           ref.shuffle_bwd(g1.cpu(), self_pos.cpu(), dst_count.cpu(), M).to(dev),
           fn, plain, library, 4 * P * M * F + 4 * n_live * (F + 1) + 4 * P,
           n_live * F, shape=f"self rows, layer 1: P={P} M={M} N={n_dst} F={F}")


def packed_phase(dev, first, results):
    """Phase 3, the packed segment sum (F=128) and edge softmax (H=4) on the
    input layer's edges, all P splits flattened with dst offset by split,
    against their plain versions (the sum bitwise against a CPU copy's in
    f32, 3e-5 in bf16 and f16; the softmax 3e-5), ``index_add_`` over the
    valid edges and ``torch.sparse.softmax`` over a hybrid COO (num_out, E,
    H) tensor. Bound: bytes (the valid rows or logits and the indices read
    once, the output written once)."""
    import numpy as np
    import torch

    from repro_torch.kernels.edge_softmax import ops as es_ops
    from repro_torch.kernels.segsum import ops as ss_ops

    lp = first.plan.layers[-1]
    P, E = lp.edge_dst.shape
    num_out = lp.self_pos.shape[1]
    N = P * num_out
    dst = (np.arange(P)[:, None] * num_out + lp.edge_dst).reshape(-1)
    mask = lp.edge_mask.reshape(-1)
    pack = ss_ops.pack_edges(dst.astype(np.int32), mask, N)
    R, EB, DB = pack["rows"], pack["edge_block"], pack["num_blocks"]
    total, n_valid = DB * EB, int(mask.sum())
    local = torch.as_tensor(pack["local_dst"], device=dev)
    emit("kernel_shapes", {"packed_input_layer": dict(
        edges=P * E, valid_edges=n_valid, num_out=N, DB=DB, EB=EB,
        slots=total)})
    gen = torch.Generator(device=dev).manual_seed(1)
    dst_v = torch.as_tensor(dst[mask], device=dev).long()
    mask_d = torch.as_tensor(mask, device=dev)

    F = 128
    contrib = torch.randn(P * E, F, device=dev, generator=gen)
    packed = ss_ops.gather_packed(contrib, pack["perm"]).contiguous()
    contrib_v = contrib[mask_d]
    fn = lambda: ss_ops.segment_sum_packed(packed, local, R, EB)  # noqa: E731
    plain = lambda: ss_ops.segment_sum_packed_ref(packed, local, R, EB)  # noqa: E731
    library = lambda: torch.zeros(N, F, device=dev).index_add_(  # noqa: E731
        0, dst_v, contrib_v)
    out = fn()
    torch.testing.assert_close(out[:N], library(), **PACKED_TOL)
    local_cpu = local.cpu()
    # bitwise against the plain version on a CPU copy (index_add_ there adds
    # in index order, as the kernel does; on the card it adds with atomics)
    want = ss_ops.segment_sum_packed_ref(packed.cpu(), local_cpu, R, EB).to(dev)
    record(results, "segment_sum_packed", out, want, fn, plain, library,
           4 * F * n_valid + 4 * total + 4 * F * DB * R, n_valid * F)
    for dtype in (torch.bfloat16, torch.float16):
        low = packed.to(dtype)
        got = ss_ops.segment_sum_packed(low, local, R, EB)
        want = ss_ops.segment_sum_packed_ref(low.cpu(), local_cpu, R, EB)
        torch.testing.assert_close(got.cpu(), want, **PACKED_TOL)
        check(torch.equal(got, ss_ops.segment_sum_packed(low, local, R, EB)),
              f"segment_sum_packed {dtype}: two launches differ")
        emit("kernel_check", {
            "name": f"segment_sum_packed ({dtype}, input layer, F={F})",
            "max_abs_err": float((got.cpu().float() - want.float()).abs().max()),
            "bitwise_vs_cpu": bool(torch.equal(got.cpu(), want)), "repeats": True})

    H = 4
    logits = 3 * torch.randn(P * E, H, device=dev, generator=gen)
    packed = ss_ops.gather_packed(logits, pack["perm"]).contiguous()
    sp = torch.sparse_coo_tensor(
        torch.stack([dst_v, torch.arange(n_valid, device=dev)]), logits[mask_d],
        (N, n_valid, H),
    ).coalesce()
    fn = lambda: es_ops.edge_softmax_packed(packed, local, R, EB)  # noqa: E731
    plain = lambda: es_ops.edge_softmax_packed_ref(packed, local, R, EB)  # noqa: E731
    library = lambda: torch.sparse.softmax(sp, 1)  # noqa: E731
    out = fn()
    lib = library().coalesce()
    want = torch.zeros(n_valid, H, device=dev)
    want[lib.indices()[1]] = lib.values()
    perm = torch.as_tensor(pack["perm"], device=dev).long()
    by_edge = torch.zeros(P * E + 1, H, device=dev).index_copy_(0, perm, out)
    torch.testing.assert_close(by_edge[:-1][mask_d], want, **PACKED_TOL)
    record(results, "edge_softmax_packed", out, plain(), fn, plain, library,
           4 * H * n_valid + 4 * total + 4 * H * total, 5 * n_valid * H,
           PACKED_TOL)
    return dst, mask, N


def packed_entry_points(dev, dst, mask, N):
    """Path B through the entry points a user calls: ``segment_ops``'s
    ``segment_sum``, ``segment_mean`` and ``edge_softmax`` with
    ``backend="packed"`` on the input layer's edges, counts at 0 just before
    and read just after, each result held against the torch backend."""
    import torch

    from repro_torch.kernels import segment_ops

    gen = torch.Generator(device=dev).manual_seed(2)
    d = torch.as_tensor(dst, device=dev)
    m = torch.as_tensor(mask, device=dev)
    x = torch.randn(len(dst), 128, device=dev, generator=gen)
    logits = torch.randn(len(dst), 4, device=dev, generator=gen)
    reset_launches()
    out = {
        op: getattr(segment_ops, op)(arg, d, m, N, backend="packed")
        for op, arg in (("segment_sum", x), ("segment_mean", x),
                        ("edge_softmax", logits))
    }
    launches = read_launches()
    check(launches["segment_sum_packed"] == 2 and launches["edge_softmax_packed"] == 1,
          f"packed entry points: launches {launches}")
    errs = {}
    for op, arg in (("segment_sum", x), ("segment_mean", x), ("edge_softmax", logits)):
        want = getattr(segment_ops, op)(arg, d, m, N, backend="torch")
        torch.testing.assert_close(out[op], want, **PACKED_TOL)
        errs[op] = float((out[op] - want).abs().max())
    emit("run", {"name": "segment_ops packed backend", "max_abs_err": errs,
                 "launches": launches})
    return launches


#: the decode kernel's shapes: SmolLM-135M's serve shape (B=8, a 1024-token
#: prompt plus 64 new tokens) first, then the other dense configs' heads
DECODE_SHAPES = {
    "smollm-135m": dict(B=8, H=9, KV=3, D=64, S=1088, mid=700),
    "phi3-mini-3.8b": dict(B=8, H=32, KV=32, D=96, S=4096, mid=2051),
    "gemma-7b": dict(B=8, H=16, KV=16, D=256, S=4096, mid=2051),
    "granite-20b": dict(B=8, H=48, KV=1, D=128, S=4096, mid=2051),
    # phase 20's heads at its cache lengths (1024 prompt rows + 16): MLA's
    # expanded keys (D = qk_nope + qk_rope = 192) and values (Dv = 128),
    # Hymba's group of 5 over its 1024-row ring
    "deepseek-v2-lite-16b": dict(B=8, H=16, KV=16, D=192, Dv=128, S=1040,
                                 mid=523),
    "deepseek-v2-236b": dict(B=8, H=128, KV=128, D=192, Dv=128, S=1040, mid=523),
    "musicgen-medium": dict(B=8, H=24, KV=24, D=64, S=1040, mid=523),
    "hymba-1.5b": dict(B=8, H=25, KV=5, D=64, S=1024, mid=515),
    "llava-next-mistral-7b": dict(B=8, H=32, KV=8, D=128, S=1040, mid=523),
}
#: the SDPA yardstick against the decode kernel in bf16: one bf16 rounding
#: of the output (at most 2^-7 of it) plus 2e-3 on outputs of about 0.03-0.05
SDPA_TOL = dict(rtol=1e-2, atol=2e-3)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "smollm-135m", 8, 1024, 64
#: the decode kernel's partial output at phase 24's shapes: one rank's 517
#: rows of the 1034-row cache (8 prompts of 1024 rows and 9 new tokens,
#: rounded up to a multiple of the two ranks), sharded by sequence over two:
#: Granite-20B's MQA k/v and DeepSeek-V2-Lite's latents expanded to its 16
#: heads (D = 192, Dv = 128)
PARTIAL_SHAPES = {
    "granite-20b": dict(B=8, H=48, KV=1, D=128, S=517),
    "deepseek-v2-lite-16b": dict(B=8, H=16, KV=16, D=192, Dv=128, S=517),
}


def flash_decode_partial_check(dev):
    """Phase 3, the decode kernel's partial output (``flash_decode_partial``:
    o float32, m, d) at ``PARTIAL_SHAPES`` in f32 and bf16: at cache_len 0
    (a shard with no valid row) exactly o = 0, m = -1e30 and d = 0, as its
    plain version gives them; at 1, mid and S, o within
    ``ref.decode_attention_bound`` of the f32 result and m and d within
    2e-4/2e-5 of the plain version on float32 copies; bit for bit on repeat.
    Its launches here are a check's, not the path's."""
    import torch

    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref

    gen = torch.Generator(device=dev).manual_seed(24)
    for arch, sh in PARTIAL_SHAPES.items():
        B, H, KV, D, S = (sh[k] for k in ("B", "H", "KV", "D", "S"))
        Dv = sh.get("Dv", D)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, S, KV, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, S, KV, Dv, device=dev, generator=gen).to(dtype)
            errs = {}
            for L in (0, 1, S // 2 + 3, S):
                n = torch.tensor([L], dtype=torch.int32, device=dev)
                o, m, d = fd.flash_decode_partial(q, k, v, n)
                _, want_m, want_d = ref.decode_attention_partial_ref(
                    q.float(), k.float(), v.float(), n.reshape(()))
                if L == 0:
                    check(bool((o == 0).all()) and bool((d == 0).all())
                          and bool((m == -1e30).all()),
                          f"flash_decode partial {arch} {dtype}: a shard with "
                          "no valid row is not o = 0, m = -1e30, d = 0")
                    errs[L] = 0.0
                else:
                    want, tol = ref.decode_attention_bound(q, k, v,
                                                           n.reshape(()))
                    diff = (o - want).abs()
                    check(bool((diff <= tol).all()),
                          f"flash_decode partial {arch} {dtype} L={L}: o "
                          f"{float(diff.max())} outside the bound")
                    torch.testing.assert_close(m, want_m, rtol=2e-4, atol=2e-5)
                    torch.testing.assert_close(d, want_d, rtol=2e-4, atol=2e-5)
                    errs[L] = float(diff.max())
                check(all(torch.equal(a, b) for a, b in zip(
                    (o, m, d), fd.flash_decode_partial(q, k, v, n))),
                    f"flash_decode partial {arch} {dtype} L={L}: two "
                    "launches differ")
            n = torch.tensor([S], dtype=torch.int32, device=dev)
            emit("kernel_check", {
                "name": f"flash_decode partial ({arch}: B={B} H={H} KV={KV} "
                        f"D={D} Dv={Dv} S={S}, {dtype})",
                "max_abs_err": errs, "empty_shard": "o = 0, m = -1e30, d = 0",
                "repeats": True,
                "ms": time_ms(lambda: fd.flash_decode_partial(q, k, v, n)),
            })


def flash_decode_phase(dev, results):
    """Phase 3, the decode-attention kernel at each dense config's head
    shape (B=8; SmolLM at the serve shape S=1088, the others at S=4096) and
    at phase 20's (MLA's D=192 keys beside Dv=128 values, MusicGen's 24 MHA
    heads, Hymba's group of 5, LLaVA's 32/8, at 1024-1040 rows), in
    f32 and bf16, with cache_len 1, mid and S: held against its plain
    version computed in f32 from the same inputs, within
    ``ref.decode_attention_bound`` (the f32 tolerance of
    tests/test_kernels.py, 2e-4/2e-5, plus in bf16 the rounding of p and of
    the output), and checked to repeat bit for bit. Timed in
    bf16 with a full cache, cold in L2 (the decode step reads each layer's
    cache after the other layers' have evicted it), beside the plain
    version and ``scaled_dot_product_attention`` with ``enable_gqa`` on
    (B, KV, S, D) tensors transposed beforehand and a cache_len mask (only
    the call is timed; the port never calls it). Bound: the larger of the
    bytes (the valid K/V rows, q and the output once) over 3.35 TB/s and
    the 2*B*H*L*(D+Dv) flops over the bf16 tensor-core rate. ``path`` says
    whether the shape took the kernel's tensor-core path (asked with D and
    Dv)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.build import typed_library
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref

    lib = typed_library("flash_decode", fd._SIGNATURES)
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for arch, sh in DECODE_SHAPES.items():
        B, H, KV, D, S = (sh[k] for k in ("B", "H", "KV", "D", "S"))
        Dv = sh.get("Dv", D)
        label = f"B={B} H={H} KV={KV} D={D}" + (f" Dv={Dv}" if Dv != D else "") \
            + f" S={S}"
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, S, KV, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, S, KV, Dv, device=dev, generator=gen).to(dtype)
            errs, of_bound = {}, {}
            for L in (1, sh["mid"], S):
                n = torch.tensor([L], dtype=torch.int32, device=dev)
                out = fd.flash_decode(q, k, v, n)
                want, tol = ref.decode_attention_bound(q, k, v, n.reshape(()))
                diff = (out.float() - want).abs()
                check(bool((diff <= tol).all()),
                      f"flash_decode {arch} {dtype} L={L}: max error "
                      f"{float(diff.max())} outside the bound")
                check(torch.equal(out, fd.flash_decode(q, k, v, n)),
                      f"flash_decode {arch} {dtype} L={L}: two launches differ")
                errs[L] = float(diff.max())
                of_bound[L] = float((diff / tol).max())
            emit("kernel_check", {"name": f"flash_decode ({arch}: {label}, {dtype})",
                                  "max_abs_err": errs,
                                  "max_err_over_bound": of_bound, "repeats": True})
        # timed in bf16 (the serve dtype) with a full cache
        n = torch.tensor([S], dtype=torch.int32, device=dev)
        fn = lambda: fd.flash_decode(q, k, v, n)  # noqa: E731
        plain = lambda: ref.decode_attention_ref(q, k, v, n.reshape(()))  # noqa: E731
        q4 = q.reshape(B, H, 1, D)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(S, device=dev) < n)[None, None, None, :]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kt, vt, attn_mask=mask, enable_gqa=True)
        out = fn()
        torch.testing.assert_close(library().reshape(B, H, Dv).float(), out.float(),
                                   **SDPA_TOL)
        want, tol = ref.decode_attention_bound(q, k, v, n.reshape(()))
        # the wrapper's own counts, which the roofline records read too
        nbytes = fd.decode_bytes(B, H, KV, S, D, Dv, q.element_size())
        flops = fd.decode_flops(B, H, S, D, Dv)
        record(results, "flash_decode", out, want, fn, plain, library,
               nbytes, flops, tol, rate=roofline.PEAK_FLOPS,
               shape=None if arch == SERVE_ARCH else f"{arch}: {label}",
               flush=flush,
               extra={"arch": arch, "chunk": fd.decode_chunk(B, KV, S, H // KV),
                      "path": "mma" if lib.flash_decode_uses_mma(
                          fd.DTYPES[q.dtype], D, Dv) else "fma"})


def check_launches(name, launches, expect, cfg, model, steps):
    """Fail unless every kernel in ``expect`` was launched, the row
    adjoint's walk was built once per row adjoint, and the shuffle adjoint
    ran the mode's count for ``steps`` optimizer steps."""
    for k in expect:
        check(launches[k] > 0, f"{name}: kernel {k} was never launched")
    # the row adjoint's walk is built by its kernels once per adjoint launch
    check(launches["src_sorted_csr"] == launches["gather_segsum_bwd_mixed"],
          f"{name}: {launches['src_sorted_csr']} walk builds for "
          f"{launches['gather_segsum_bwd_mixed']} row adjoints")
    # a mesh step runs its R parts' adjoints; a P = 1 split sends nothing
    # (S = 0), as dp does
    mode = "dp" if cfg.num_devices == 1 else cfg.mode
    per_step = (SHUFFLE_BWD_OVERLAP if cfg.shuffle_overlap
                else SHUFFLE_BWD_PER_STEP)[mode][model]
    want = steps * per_step * max(cfg.num_replicas, 1)
    check(launches["shuffle_bwd"] == want,
          f"{name}: {launches['shuffle_bwd']} shuffle_bwd launches, expected {want}")


def run_trainer(ds, spec, cfg, dev, steps, name, expect, epochs=1):
    """One trainer run of ``epochs`` epochs of ``steps`` steps, with launch
    counts set to 0 just before and read just after; fails if a kernel the
    path needs was never launched. Returns the launches, the trainer, every
    epoch's stats and every step's loss."""
    import numpy as np
    import torch

    from repro_torch.train.trainer import Trainer

    # memory is read against what earlier runs left allocated: the trainer's
    # resident state (weights, a replicated or cached block) and the run's peak
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(ds, spec, cfg, device=dev)
    t_setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    reset_launches()
    epoch_stats = [tr.train_epoch(max_iters=steps) for _ in range(epochs)]
    launches = read_launches()
    iters = [it for e in epoch_stats for it in e.iters]
    losses = [it.loss for it in iters]
    check(len(losses) == steps * epochs,
          f"{name}: {len(losses)} steps, expected {steps * epochs}")
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    check_launches(name, launches, expect, cfg, spec.model, len(iters))
    MEMORY[name] = (resident, torch.cuda.max_memory_allocated() - base)
    emit("run", {
        "name": name, "plan_source": cfg.plan_source, "setup_s": t_setup,
        "presample_s": tr.t_presample, "partition_s": tr.t_partition,
        "losses": losses,
        "epochs": epochs, "steps_per_epoch": steps,
        # a step's host stages, on the producer thread when pipelined
        "step_ms": [1e3 * (it.t_sample + it.t_split + it.t_load + it.t_compute)
                    for it in iters],
        "compute_ms": [1e3 * it.t_compute for it in iters],
        "sample_ms": [1e3 * it.t_sample for it in iters],
        "split_ms": [1e3 * it.t_split for it in iters],
        "load_ms": [1e3 * it.t_load for it in iters],
        # the consumer's side: blocked on the source, staging + enqueue, sync
        "wait_ms": [1e3 * it.t_wait for it in iters],
        "stage_ms": [1e3 * it.t_stage for it in iters],
        "device_ms": [1e3 * it.t_device for it in iters],
        "epoch_wall_ms": [1e3 * e.t_wall for e in epoch_stats],
        # each epoch's wall to the end of its first step (the pipeline
        # fill), and its steady step: the rest of the wall over the rest
        "first_iter_ms": [1e3 * e.t_first_iter for e in epoch_stats],
        "steady_step_ms": [1e3 * e.steady_step_seconds() for e in epoch_stats],
        "num_replicas": cfg.num_replicas,
        "resident_bytes": MEMORY[name][0],
        "peak_bytes": MEMORY[name][1],
        "launches": launches,
        "source_stats": [e.pipeline for e in epoch_stats],
        "shuffle_overlap": cfg.shuffle_overlap,
        "shuffle_chunks": cfg.shuffle_chunks,
        "cache_mode": cfg.cache_mode,
        "wire_bytes": [it.wire_bytes for it in iters],
        "load_breakdown": [
            None if it.load_breakdown is None else
            [it.load_breakdown.local_hit, it.load_breakdown.remote_hit,
             it.load_breakdown.host_miss] for it in iters],
        "mode": cfg.mode,
        "replicated_rows": tr.replication.num_replicated if tr.replication else 0,
        "loaded_rows": [it.loaded_rows for it in iters],
        "computed_edges": [it.computed_edges for it in iters],
        "shuffle_rows": [it.shuffle_rows for it in iters],
        "padded_edge_slots": [it.padded_edge_slots for it in iters],
        "busiest_edges": [it.busiest_edges for it in iters],
        "load_imbalance": [it.load_imbalance for it in iters],
        "cross_edge_fraction": [it.cross_edge_fraction for it in iters],
    })
    return launches, tr, epoch_stats, losses


def device_source_phase(papers, cfg, dev):
    """Phase 7: the main path's SAGE run on the device plan source and on the
    pipelined device source, 3 epochs each, bitwise equal; then the card's
    sample of the first batch against the CPU's, and one sampling call under
    the sync guard. Returns the launches of both runs and the pipelined
    run's losses."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.models.gnn import GNNSpec
    from repro_torch.sampler import DeviceSampler
    from repro_torch.sampler.engine import _sample_device, to_host

    total, losses, trainers, sampler_stats = {}, {}, {}, {}
    for source in ("device", "device_pipelined"):
        launches, trainers[source], stats, losses[source] = run_trainer(
            papers, GNNSpec(model="sage"), replace(cfg, plan_source=source),
            dev, 3, f"sage, {source} source",
            ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
             "shuffle_bwd", "wavefront_expand"), epochs=3,
        )
        stats = sampler_stats[source] = stats[-1].pipeline
        check(stats["sampler_batches"] - stats["sampler_fallbacks"] >= 1,
              f"{source}: no batch sampled on the card without a fallback {stats}")
        # every device sampling run launches the kernel once per layer, also
        # when it overflows and the batch falls back to the host sampler
        check(launches["wavefront_expand"] == len(FANOUTS) * stats["sampler_batches"],
              f"{source}: {launches['wavefront_expand']} wavefront launches "
              f"for {stats['sampler_batches']} sampled batches")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    check(losses["device"] == losses["device_pipelined"],
          f"device source: serial and pipelined losses differ {losses}")
    emit("pipeline_parity", {"sources": ["device", "device_pipelined"],
                             "bitwise_equal": True, "steps": len(losses["device"])})
    dcfg = replace(cfg, plan_source="device")
    tr = trainers["device"]

    card = tr.device_sampler
    card.refresh_caps()  # the epoch boundary: any flagged cap has grown
    cpu = DeviceSampler(papers.graph, tr.partition.assignment, dcfg.num_devices,
                        FANOUTS, dcfg.seed, host_sampler=tr.sampler, device="cpu")
    cpu._caps = dict(card._caps)
    targets = tr.sampler.epoch_targets(0)[0]
    a, b = card.sample_batch(targets, 0, 0), cpu.sample_batch(targets, 0, 0)
    check(card.stats()["sampler_epoch_fallbacks"] == 0,
          "device source: the card's check sample fell back to the host")
    for la, lb in zip(a.layers, b.layers, strict=True):
        for f in ("src", "dst", "edge_id"):
            check(np.array_equal(getattr(la, f), getattr(lb, f)),
                  f"device source: card and CPU samples differ in {f}")
    for fa, fb in zip(a.frontiers, b.frontiers, strict=True):
        check(np.array_equal(fa, fb), "device source: frontiers differ")

    # one sampling call under the sync guard, timed part by part on the
    # host clock: upload, enqueueing the loop, the device finishing it, the
    # one transfer back, and assembling the host sample
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_dev, keys = card.device_inputs(targets, 0, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _sample_device(card._dev, t_dev, len(targets), keys,
                             caps=card.caps_tuple(), fanouts=FANOUTS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    fronts, counts, layers, flags = to_host(out)
    t4 = time.perf_counter()
    card._assemble(targets, fronts, counts, layers)
    t5 = time.perf_counter()
    # what the enqueue is made of: the loop's top-level torch calls (views
    # included), counted by the profiler on a further call
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _sample_device(card._dev, t_dev, len(targets), keys,
                       caps=card.caps_tuple(), fanouts=FANOUTS)
    n_calls = sum(1 for e in prof.events() if e.cpu_parent is None)
    emit("device_source", {
        "sampler": sampler_stats,
        "card_vs_cpu_sample": "bitwise equal",
        "sync_debug_mode_error": "no sync raised",
        "sample_breakdown_ms": {
            "upload": 1e3 * (t1 - t0), "enqueue": 1e3 * (t2 - t1),
            "device_after_enqueue": 1e3 * (t3 - t2),
            "transfer": 1e3 * (t4 - t3), "assemble": 1e3 * (t5 - t4),
        },
        "sample_device_torch_calls": n_calls,
        "transfer_bytes": 4 * sum(
            a.size for a in (*fronts, *counts, *(v for lay in layers
                                                  for v in lay.values()))),
        "edges_per_layer": [int(lay["valid"].sum()) for lay in layers],
        "frontier_sizes": [int(c.sum()) for c in counts],
        "overflow": sorted(k for k, f in flags.items() if f),
    })
    return total, losses["device_pipelined"]


def _softmax_index_add(logits, dst, mask, num_out):
    """The torch backend's edge softmax as it was before its denominator was
    summed in a fixed order: the same body with ``index_add``, which adds
    with float atomics on the card. A yardstick of what the fixed order
    costs; the port never calls it."""
    import torch

    dst = dst.long()
    neg = torch.finfo(logits.dtype).min / 2
    masked = torch.where(mask[:, None], logits, torch.full_like(logits, neg))
    with torch.no_grad():
        seg_max = torch.full((num_out, logits.shape[1]), neg, dtype=logits.dtype,
                             device=logits.device)
        seg_max = seg_max.scatter_reduce(0, dst[:, None].expand_as(masked),
                                         masked, "amax")
    ex = torch.where(mask[:, None], torch.exp(masked - seg_max[dst]),
                     torch.zeros_like(logits))
    denom = torch.zeros_like(seg_max).index_add(0, dst, ex)
    return ex / denom[dst].clamp(min=torch.finfo(logits.dtype).tiny)


def determinism_phase(papers, cfg, dev, dst, mask, N):
    """Phase 8: two identical 2-step runs must be bitwise equal, for SAGE and
    GAT on the serial source and SAGE on the device source; then GAT's edge
    softmax alone, both backends, five calls each on the input layer's edges
    (H=4), must be bitwise equal. What the torch backend's fixed-order
    denominator costs: forward plus backward of the softmax at the input
    layer, timed against the same body with an ``index_add`` denominator."""
    from dataclasses import replace

    import torch

    from repro_torch.kernels import segment_ops
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import Trainer

    for name, model, c in (
        ("sage", "sage", cfg),
        ("gat", "gat", cfg),
        ("sage, device source", "sage", replace(cfg, plan_source="device")),
    ):
        spec = GNNSpec(model=model, num_heads=4)
        # two trainers built alike: seeded partition, sampler and weights
        runs = [Trainer(papers, spec, c, device=dev) for _ in range(2)]
        same_start = all(
            torch.equal(x, y) for x, y in zip(runs[0].params, runs[1].params)
        )
        losses = [[it.loss for it in tr.train_epoch(max_iters=2).iters]
                  for tr in runs]
        same_params = all(
            torch.equal(x, y) for x, y in zip(runs[0].params, runs[1].params)
        )
        equal = losses[0] == losses[1] and same_params
        emit("determinism", {"name": name, "same_start": same_start,
                             "losses_a": losses[0],
                             "losses_b": losses[1],
                             "bitwise_equal": equal})
        check(same_start and equal, f"determinism: two {name} runs differ")

    gen = torch.Generator(device=dev).manual_seed(3)
    d = torch.as_tensor(dst, device=dev)
    m = torch.as_tensor(mask, device=dev)
    logits = 3 * torch.randn(len(dst), 4, device=dev, generator=gen)
    for backend in segment_ops.BACKENDS:
        outs = [segment_ops.edge_softmax(logits, d, m, N, backend=backend)
                for _ in range(5)]
        equal = all(torch.equal(outs[0], o) for o in outs[1:])
        emit("determinism", {
            "name": f"segment_ops.edge_softmax, backend={backend!r}, input layer",
            "bitwise_equal": equal,
            "max_abs_diff": max(float((outs[0] - o).abs().max()) for o in outs[1:]),
        })
        check(equal, f"determinism: edge_softmax backend={backend!r} differs")

    lg = logits.clone().requires_grad_()
    cot = torch.randn(logits.shape, device=dev, generator=gen)
    torch.testing.assert_close(segment_ops.edge_softmax(lg, d, m, N),
                               _softmax_index_add(lg, d, m, N), **PACKED_TOL)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(lg, d, m, N), lg, cot)

    emit("edge_softmax_cost", {
        "edges": len(dst), "heads": 4, "num_out": N,
        "fixed_order_fwd_bwd_ms": time_ms(fwd_bwd(segment_ops.edge_softmax)),
        "index_add_fwd_bwd_ms": time_ms(fwd_bwd(_softmax_index_add)),
    })


def serve_model(dev, seed=0):
    """SmolLM-135M at full width (bf16) with seeded random weights on the
    card, and the serve path's prompts: 8 requests of 1024 tokens."""
    import torch

    from repro_torch import serve
    from repro_torch.models.transformer.model import init_params

    cfg = serve.serve_config(SERVE_ARCH, reduced=False)
    model = init_params(cfg, torch.Generator(dev).manual_seed(seed))
    prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed)
    return model, torch.as_tensor(prompts, device=dev)


def serve_determinism(model, prompts):
    """Phase 8: two identical full-width serve runs must give bitwise equal
    tokens and logits."""
    import torch

    from repro_torch import serve

    a, b = (serve.generate(model, prompts, SERVE_NEW) for _ in range(2))
    equal = (torch.equal(a["tokens"], b["tokens"])
             and torch.equal(a["step_logits"], b["step_logits"]))
    emit("determinism", {"name": f"serve {SERVE_ARCH}, full width",
                         "bitwise_equal": equal})
    check(equal, "determinism: two serve runs differ")


def serve_phase(model, prompts):
    """Phase 9: the serve path at full width, counts at 0 just before and
    read just after. Fails unless the logits are finite and the decode
    kernel launched once per layer and decode step."""
    import statistics

    import torch

    from repro_torch import serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve.generate(model, prompts, SERVE_NEW)
    launches = read_launches()
    cfg, steps = model.cfg, SERVE_NEW - 1
    check(tuple(out["tokens"].shape) == (SERVE_BATCH, SERVE_NEW),
          f"serve: tokens {tuple(out['tokens'].shape)}")
    check(bool(torch.isfinite(out["step_logits"]).all()), "serve: non-finite logits")
    check(launches["flash_decode"] == cfg.num_layers * steps,
          f"serve: {launches['flash_decode']} decode-kernel launches, expected "
          f"{cfg.num_layers} layers x {steps} steps")
    emit("serve", {
        "arch": cfg.name, "dtype": cfg.dtype, "batch": SERVE_BATCH,
        "prompt_len": SERVE_PROMPT, "new_tokens": SERVE_NEW,
        "prefill_ms": out["prefill_ms"],
        "decode_ms_per_step": statistics.median(out["step_ms"]),
        "step_ms": out["step_ms"],
        "decode_ms": out["decode_ms"],
        "tokens_per_s": SERVE_BATCH * steps / (out["decode_ms"] / 1e3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "tokens_0": out["tokens"][0, :16].tolist(),
    })
    serve_decode_profile(model, prompts)
    return launches


def _host_yardstick_ms() -> float:
    """The time of a fixed pure-Python loop on this thread: the host CPU's
    own speed, which no torch call or allocation changes."""
    t0 = time.perf_counter()
    sum(i * i for i in range(20000))
    return 1e3 * (time.perf_counter() - t0)


def serve_decode_profile(model, prompts, window=3):
    """Where a decode step's time goes, and whether it changes within a
    run. One step runs under ``torch.cuda.set_sync_debug_mode("error")``
    (fails if that prototype detector raises on a host sync). Then the
    serve loop's ``SERVE_NEW - 1`` decode steps run against a zero cache of
    the serve length; each records its host time (the decode call and the
    argmax, no sync) and, right after, ``_host_yardstick_ms``.
    ``torch.profiler`` traces the first and the last ``window`` steps: the
    device time per step by kernel, the decode kernel's share, the device
    idle share of the traced wall time, the top-level torch calls per step
    and their mean host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer.model import init_caches, make_decode_step

    cfg = model.cfg
    B = prompts.shape[0]
    steps = SERVE_NEW - 1
    caches = init_caches(cfg, B, SERVE_PROMPT + SERVE_NEW, prompts.device)
    decode = make_decode_step(cfg)
    tok = prompts[:, -1:]
    pos = torch.tensor(SERVE_PROMPT, device=prompts.device)
    host_ms, yard_ms, traced = [], [], {}
    with torch.inference_mode():
        decode(model, tok, pos, caches)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(model, tok, pos, caches)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for name, lo, hi in (("first", 0, window), ("middle", window, steps - window),
                             ("last", steps - window, steps)):
            tracer = (contextlib.nullcontext() if name == "middle" else
                      profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            with tracer as prof:
                t0 = time.perf_counter()
                for t in range(lo, hi):
                    t1 = time.perf_counter()
                    logits, _ = decode(model, tok, pos + t, caches)
                    logits[:, -1].argmax(dim=-1)
                    host_ms.append(1e3 * (time.perf_counter() - t1))
                    yard_ms.append(_host_yardstick_ms())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if prof is not None:
                traced[name] = _decode_trace(prof, wall, hi - lo)
    half = steps // 2
    emit("serve_profile", {
        "steps": steps, "traced_steps": window,
        "sync_debug_mode_error": "no sync raised",
        **{f"{name}_{key}": val for name, d in traced.items() for key, val in d.items()},
        "host_ms_per_step": host_ms,
        "yardstick_ms_per_step": yard_ms,
        "host_ms_median_first_half": statistics.median(host_ms[window:half]),
        "host_ms_median_second_half": statistics.median(host_ms[half:steps - window]),
        "yardstick_ms_median_first_half": statistics.median(yard_ms[window:half]),
        "yardstick_ms_median_second_half": statistics.median(yard_ms[half:steps - window]),
    })


def _decode_trace(prof, wall, steps):
    """A profiler trace of ``steps`` decode steps in ``wall`` seconds,
    reduced to per-step numbers (``trace_per_step``) and the decode
    kernel's device ms a step."""
    import torch

    from repro_torch.profile_decode import trace_per_step

    return {**trace_per_step(prof, wall, steps),
            "flash_decode_device_ms_per_step": sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "flash_decode" in e.key) / 1e3 / steps}


def serve_parity_phase(dev):
    """Phase 10: reduced SmolLM (2 layers, f32) from the same weights,
    prefill and 8 decode steps on the card (the kernel) and on the CPU (its
    plain version): every step's logits agree to rtol/atol 1e-4 and the
    greedy tokens are equal."""
    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.models.transformer.model import init_params

    cfg = serve.serve_config(SERVE_ARCH, reduced=True)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(dev)
    prompts = serve.make_prompts(cfg, 4, 32, 0)
    reset_launches()
    card = serve.generate(card_model, torch.as_tensor(prompts, device=dev), 9)
    launches = read_launches()
    cpu = serve.generate(cpu_model, torch.as_tensor(prompts), 9)
    check(launches["flash_decode"] == cfg.num_layers * 8,
          f"serve parity: {launches['flash_decode']} decode-kernel launches")
    np.testing.assert_allclose(card["step_logits"].numpy(),
                               cpu["step_logits"].numpy(), rtol=1e-4, atol=1e-4)
    check(torch.equal(card["tokens"], cpu["tokens"]),
          "serve parity: greedy tokens differ between card and CPU")
    emit("card_vs_cpu", {
        "model": f"serve {cfg.name} reduced", "steps": 8,
        "max_abs_logit_diff": float(
            (card["step_logits"] - cpu["step_logits"]).abs().max()),
        "tokens_equal": True,
    })


def staging_phase():
    """Phase 4b: ``profile_step --plan-source pipelined`` in a process of its
    own: one profiler window of two steady pipelined SAGE steps, which must
    hold no pageable host-to-device copy and two pinned ones a step (the
    packed plan with its labels, and the feature block). In this script's
    own process the profiler recorded the copies of one step of the two
    (three runs, also with the window taken again), where a fresh process
    records all four."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.profile_step", "--plan-source",
         "pipelined"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    check(proc.returncode == 0,
          f"staging: profile_step failed ({proc.returncode}): {proc.stderr[-2000:]}")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])["profile"]
    copies, steps = prof["h2d_copies"], prof["steps"]
    check("pageable" not in copies,
          f"staging: pageable host-to-device copies in the steps: {copies}")
    pinned = copies.get("pinned", {"count": 0, "device_ms": 0.0})
    check(pinned["count"] == 2 * steps,
          f"staging: {pinned['count']} pinned copies for {steps} steps")
    emit("staging", {
        "plan_source": "pipelined", "steps": steps, "h2d_copies": copies,
        "pinned_copies_per_step": pinned["count"] / steps,
        "pinned_device_ms_per_step": pinned["device_ms"] / steps,
        "window_wall_ms": prof["wall_ms"], "window_device_ms": prof["device_ms"],
        "device_idle_share": prof["device_idle_share"],
        "wait_ms": prof["wait_ms"], "stage_ms": prof["stage_ms"],
        "device_sync_ms": prof["device_sync_ms"],
    })


def faults_phase(papers, cfg, dev, clean):
    """Phase 11: SAGE on ``device_pipelined`` under faults. A transient fault
    (twice) and a producer crash must give ``clean``'s first epoch bit for
    bit; a build delayed past ``stall_timeout_s`` must raise
    ``PipelineStallError`` naming its index; a poisoned batch under
    ``skip_nonfinite`` must leave params and optimizer state bitwise as the
    step before left them."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.faults import FaultAction, FaultInjector, PipelineStallError
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import Trainer

    fcfg = replace(cfg, plan_source="device_pipelined", plan_retries=2,
                   plan_retry_backoff_s=0.01)
    spec = GNNSpec(model="sage")
    inj = FaultInjector([FaultAction("transient", batch=1, times=2),
                         FaultAction("crash", batch=2)])
    st = Trainer(papers, spec, fcfg, device=dev, injector=inj).train_epoch(max_iters=3)
    losses = [it.loss for it in st.iters]
    check(losses == clean[:3], f"faults: recovered losses {losses} != clean {clean[:3]}")
    recovery = {k: st.pipeline[k] for k in ("retries", "worker_crashes", "respawns")}
    check(recovery == {"retries": 2, "worker_crashes": 1, "respawns": 1},
          f"faults: recovery counters {recovery}")

    stall_s = 1.5
    inj = FaultInjector([FaultAction("delay", batch=1, delay_s=3 * stall_s)])
    tr = Trainer(papers, spec, replace(fcfg, stall_timeout_s=stall_s), device=dev,
                 injector=inj)
    t0 = time.perf_counter()
    try:
        tr.train_epoch(max_iters=3)
    except PipelineStallError as e:
        stall, raised_after = e, time.perf_counter() - t0
    else:
        raise RuntimeError("faults: a delay past stall_timeout_s did not raise")
    check(stall.index == 1 and "index 1" in str(stall),
          f"faults: the watchdog named {stall.index}: {stall}")

    # epoch 0 takes one clean step; epoch 1's first batch is poisoned
    inj = FaultInjector([FaultAction("poison", epoch=1, batch=0)])
    tr = Trainer(papers, spec, replace(fcfg, skip_nonfinite=True), device=dev,
                 injector=inj)
    tr.train_epoch(max_iters=1)
    before = [t.clone() for t in tr._opt_tensors()]
    step_before = tr.opt_state.step
    st = tr.train_epoch(max_iters=1)
    frozen = all(torch.equal(a, b) for a, b in zip(before, tr._opt_tensors(),
                                                   strict=True))
    check(frozen and tr.opt_state.step == step_before,
          "faults: the poisoned step changed params or optimizer state")
    check(tr.nonfinite_skips == 1 and not np.isfinite(st.iters[0].loss),
          f"faults: nonfinite_skips {tr.nonfinite_skips}, loss {st.iters[0].loss}")
    emit("faults", {
        "plan_source": "device_pipelined", "recovered_losses": losses,
        "bitwise_equal_to_clean": True, "recovery": recovery,
        "stall": {"index": stall.index, "waited_s": stall.waited_s,
                  "stall_timeout_s": stall_s,
                  # the epoch's raise, after close() joined the delayed worker
                  "raised_after_s": raised_after},
        "poisoned_step": {"params_bitwise_unchanged": frozen,
                          "nonfinite_skips": tr.nonfinite_skips,
                          "reported_loss": repr(st.iters[0].loss)},
    })


def tracing_phase(papers, cfg, dev, plain):
    """Phase 12: phase 4's pipelined SAGE run again with tracing on: losses
    bitwise equal to ``plain``, a valid trace, its stall classes."""
    from dataclasses import replace

    from repro_torch.models.gnn import GNNSpec
    from repro_torch.obs.report import load_trace, summarize, validate_trace
    from repro_torch.train.trainer import Trainer

    path = ROOT / "build" / "obs" / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tcfg = replace(cfg, plan_source="pipelined", obs_trace=True, obs_path=str(path))
    tr = Trainer(papers, GNNSpec(model="sage"), tcfg, device=dev)
    losses = [it.loss for _ in range(3) for it in tr.train_epoch(max_iters=3).iters]
    check(losses == plain, f"tracing: traced losses {losses} != untraced {plain}")
    trace = load_trace(path)
    errors = validate_trace(trace)
    check(errors == [], f"tracing: invalid trace {errors}")
    summary = summarize(trace)
    check(summary["steps"] == len(losses), f"tracing: {summary['steps']} step spans")
    emit("tracing", {
        "trace": str(path.relative_to(ROOT)), "bitwise_equal": True,
        "validate_trace": errors, "steps": summary["steps"],
        "stall_classes": summary["stall_classes"],
        "stages_ms": {k: {"count": v["count"], "p50": v["p50_ms"], "max": v["max_ms"]}
                      for k, v in summary["stages"].items()},
        "metrics": {k: v for k, v in summary["metrics"].items()
                    if k.startswith(("sig/", "fault/", "hwm/", "source/"))},
    })


def scaled_close(name, got, want, tol, hold=True):
    """Hold ``got`` to ``want`` within ``tol``'s rtol, and its atol in units
    of ``want``'s largest magnitude (at least 1): the overlap schedule
    reassociates each destination's sum and the bf16 wire rounds each sent
    value once, so an entry's error follows the scale of the rows summed
    into it, not its own size. Returns the errors, with the count of entries
    outside the unscaled tolerance; ``hold=False`` only measures them."""
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    diff = (got.float() - want.float()).abs()
    rel = tol["rtol"] * want.abs()
    if hold:
        check(bool((diff <= tol["atol"] * scale + rel).all()),
              f"{name}: max error {float(diff.max())} outside {tol} at scale {scale}")
    return {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "scale": scale, "entries": diff.numel(),
            "outside_unscaled": int((diff > tol["atol"] + rel).sum())}


def fwd_grads(spec, gnn, feats, pa, labels, rep_block=None):
    """The target logits, the masked cross-entropy and its gradients for one
    forward on the card."""
    import torch

    from repro_torch.models.gnn import gnn_forward
    from repro_torch.train.loss import masked_softmax_xent

    valid = pa["target_mask"]
    out = gnn_forward(spec, list(gnn.layers), feats, pa, rep_block=rep_block)
    loss = masked_softmax_xent(out, labels, valid)
    grads = torch.autograd.grad(loss, list(gnn.parameters()))
    return out.detach()[valid], loss.detach(), grads


def overlap_parity(dev, first, plan):
    """Phase 13a: the overlap forward and gradients against the blocking
    ones on the card, the three models at full width: the target logits at
    5e-5 (fp32 wire) and 5e-2 (bf16 wire), every gradient at 3e-4, each
    ``scaled_close``. GAT's bf16 wire is measured, not held: it sends its
    a_src scores in bf16, whose magnitude (~1e2 with these random weights)
    costs up to 0.5 a score, and the edge softmax turns that into factors
    of up to e^0.5 on the attention weights (the JAX package's schedule
    sends them the same way)."""
    from dataclasses import replace

    import torch

    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train import plan_io

    pa = plan_io.plan_to_device(plan, dev, with_halves=True)
    feats = torch.as_tensor(plan_io.load_features(plan, first.ds.features),
                            device=dev)
    labels = torch.as_tensor(plan_io.load_labels(plan, first.ds.labels),
                             device=dev)
    for model in ("sage", "gcn", "gat"):
        spec = GNNSpec(model=model, num_heads=4)
        gnn = GNN(spec, generator=torch.Generator().manual_seed(0)).to(dev)

        def run(s, gnn=gnn):
            out, _, grads = fwd_grads(s, gnn, feats, pa, labels)
            return out, grads

        ref_out, ref_g = run(spec)
        errs = {}
        for chunks, wire in ((1, "float32"), (4, "float32"), (2, "bfloat16")):
            out, grads = run(replace(spec, overlap=True, shuffle_chunks=chunks,
                                     wire_dtype=wire))
            key = f"chunks{chunks}_{wire}"
            fp32 = wire == "float32"
            errs[key] = {"logits": scaled_close(
                f"{model} {key} logits", out, ref_out,
                OVERLAP_TOL if fp32 else WIRE_TOL,
                hold=fp32 or model != "gat")}
            if fp32:
                errs[key]["grads"] = [
                    scaled_close(f"{model} {key} grad {i}", a, b, ADJ_TOL)
                    for i, (a, b) in enumerate(zip(grads, ref_g, strict=True))]
        ms = {name: time_ms(lambda s=s: run(s), iters=5, warmup=1)
              for name, s in (("blocking", spec),
                              ("overlap_chunks1", replace(spec, overlap=True)),
                              ("overlap_chunks4", replace(spec, overlap=True,
                                                          shuffle_chunks=4)))}
        emit("overlap_parity", {"model": model, "errors": errs,
                                "tolerance": {"fp32": OVERLAP_TOL, "grads": ADJ_TOL,
                                              "bf16_wire": WIRE_TOL},
                                "fwd_bwd_event_ms": ms})


def overlap_kernels(dev, plan):
    """Phase 13b: each half's kernels at their largest launch, and the
    shuffle adjoint at GAT's score width, bitwise against their plain
    versions on a CPU copy."""
    import torch

    from repro_torch.kernels.gather_segsum import kernel, ops, ref
    from repro_torch.kernels.gather_segsum.layout import AGG_ROWS as R
    from repro_torch.kernels.shuffle import kernel as sh
    from repro_torch.kernels.shuffle import ref as sh_ref

    def on_cpu(fn, *args):
        return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))

    P, L = plan.num_devices, plan.num_layers
    largest = {}
    for li, lp in enumerate(plan.layers):
        F = 128 if li == L - 1 else 256
        for side in "lr":
            valid = int((getattr(lp, f"{side}pack_dst") < R).sum())
            if valid * F > largest.get(side, (0,))[0]:
                largest[side] = (valid * F, li, F, valid)
    gen = torch.Generator(device=dev).manual_seed(13)
    detail = []
    for side, (_, li, F, valid) in sorted(largest.items()):
        lp = plan.layers[li]
        M = lp.n_local if side == "l" else P * lp.send_idx.shape[2]
        num_out = lp.self_pos.shape[1]
        src = torch.as_tensor(getattr(lp, f"{side}edge_src"), device=dev)
        perm = torch.as_tensor(getattr(lp, f"{side}pack_perm"), device=dev)
        pd = torch.as_tensor(getattr(lp, f"{side}pack_dst"), device=dev)
        pack_src = ops._pack_src(src, perm, pd, M)
        rows = torch.randn(P, M, F, device=dev, generator=gen)
        g = torch.randn(P, num_out, F, device=dev, generator=gen)
        csr = kernel.src_sorted_csr(pack_src, pd, M, num_out)
        for got, want in zip(csr, on_cpu(ref.src_sorted_csr_ref, pack_src, pd, M,
                                         num_out), strict=True):
            check(torch.equal(got.cpu(), want), f"{side} half: walk differs")
        checks = {
            "gather_segsum_fwd": (
                kernel.gather_segsum_fwd(rows, pack_src, pd, None, num_out),
                on_cpu(ref.gather_segsum_fwd_packed, rows, pack_src, pd, None,
                       num_out)),
            "gather_segsum_bwd_mixed": (
                kernel.gather_segsum_bwd_mixed(g, pack_src, pd, None, M, csr),
                on_cpu(ref.gather_segsum_bwd_mixed_packed, g, pack_src, pd,
                       None, M)),
        }
        # GAT's head chunk at 4 chunks of 4 heads: one head of 64 columns,
        # its weights a strided slice of alpha packed as the op packs them
        dh = 64
        alpha = torch.randn(P, src.shape[1], 4, device=dev, generator=gen)
        flat = perm.reshape(P, -1).long().clamp(0, src.shape[1] - 1)
        live = (pd.reshape(P, -1) < R).float()
        w = (torch.gather(alpha[:, :, 1:2], 1, flat[:, :, None])
             * live[:, :, None]).contiguous()
        rows_c, g_c = rows[:, :, :dh].contiguous(), g[:, :, :dh].contiguous()
        checks["gather_segsum_fwd, head chunk"] = (
            kernel.gather_segsum_fwd(rows_c, pack_src, pd, w, num_out),
            on_cpu(ref.gather_segsum_fwd_packed, rows_c, pack_src, pd, w, num_out))
        checks["gather_segsum_bwd_mixed, head chunk"] = (
            kernel.gather_segsum_bwd_mixed(g_c, pack_src, pd, w, M),
            on_cpu(ref.gather_segsum_bwd_mixed_packed, g_c, pack_src, pd, w, M))
        checks["gather_segsum_bwd_w, head chunk"] = (
            kernel.gather_segsum_bwd_w(rows_c, g_c, pack_src, pd, 1),
            on_cpu(ref.gather_segsum_bwd_w_packed, rows_c, g_c, pack_src, pd, 1))
        for name, (got, want) in checks.items():
            check(torch.equal(got.cpu(), want),
                  f"{side} half, layer {li}: {name} differs from its plain version")
        detail.append({"half": {"l": "local", "r": "remote"}[side], "layer": li,
                       "P": P, "rows": M, "F": F, "head_chunk_F": dh,
                       "num_out": num_out, "DB": pd.shape[1], "EB": pd.shape[2],
                       "valid_slots": valid, "bitwise_vs_cpu": sorted(checks)})
    # GAT's eager score exchange: the send gather's adjoint at width H=4, at
    # the input layer (its scores take a gradient through w)
    lp = plan.layers[-1]
    idx = torch.as_tensor(lp.send_idx, device=dev)
    count = torch.as_tensor(lp.send_count, device=dev)
    S = idx.shape[2]
    live = torch.arange(S, device=dev)[None, None, :] < count[:, :, None]
    g = torch.randn(P, P, S, 4, device=dev, generator=gen) * live[..., None]
    got = sh.shuffle_bwd(g, idx, count, lp.n_local)
    check(torch.equal(got.cpu(), on_cpu(sh_ref.shuffle_bwd, g, idx, count,
                                        lp.n_local)),
          "shuffle_bwd at the score width differs from its plain version")
    detail.append({"kernel": "shuffle_bwd", "layer": L - 1, "P": P, "S": S,
                   "F": 4, "rows": lp.n_local,
                   "valid_slots": int(lp.send_count.sum()), "bitwise_vs_cpu": True})
    emit("kernel_detail", {"name": "overlap_halves", "launches": detail})


def overlap_phase(dev, first, cfg, blocking, total):
    """Phase 13: the overlap schedule. ``blocking`` is phase 4's serial
    losses; the runs' launches are added to ``total``."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.models.gnn import GNNSpec

    overlap_parity(dev, first, first.plan)
    overlap_kernels(dev, first.plan)
    ocfg = replace(cfg, shuffle_overlap=True, shuffle_chunks=4)
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
            "shuffle_bwd")
    losses = {}
    for source in ("serial", "pipelined"):
        launches, _, _, losses[source] = run_trainer(
            first.ds, GNNSpec(model="sage"), replace(ocfg, plan_source=source),
            dev, 3, f"sage overlap, {source} source", both, epochs=2)
        for k in total:
            total[k] += launches[k]
    check(losses["serial"] == losses["pipelined"],
          f"overlap: serial and pipelined losses differ {losses}")
    np.testing.assert_allclose(losses["serial"], blocking[:6], rtol=1e-4,
                               atol=1e-6)
    launches, _, _, gat = run_trainer(
        first.ds, GNNSpec(model="gat", num_heads=4), ocfg, dev, 2,
        "gat overlap", both + ("gather_segsum_bwd_w",))
    for k in total:
        total[k] += launches[k]
    emit("overlap", {"sage_serial_equals_pipelined": True,
                     "sage_vs_blocking_max_rel": float(np.max(
                         np.abs(np.array(losses["serial"]) - blocking[:6])
                         / np.abs(blocking[:6]))),
                     "gat_losses": gat})


def cache_phase(first, cfg, dev, serial, device_pipelined, total):
    """Phase 14: the feature cache. ``serial`` and ``device_pipelined`` are
    phase 4's and phase 7's uncached losses; the runs' launches are added to
    ``total``."""
    import json as _json
    from dataclasses import replace

    import torch

    from repro_torch.core.shuffle import sim_serve_features
    from repro_torch.graph.cache import FeatureCache
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train import plan_io
    from repro_torch.train.trainer import Trainer

    papers = first.ds
    ccfg = replace(cfg, cache_mode="partitioned",
                   cache_capacity_per_device=CACHE_ROWS)
    spec = GNNSpec(model="sage")
    tr = Trainer(papers, spec, ccfg, device=dev)

    # (a) the first batch's served block against the host gather
    batch = next(iter(tr.plan_source_for(0, 1)))
    plan, cp = batch.plan, batch.cache_plan
    want = plan_io.gather_features(plan, papers.features)
    valid = torch.as_tensor(plan.node_mask[-1])
    distributed = FeatureCache(
        papers.graph.num_nodes, ccfg.num_devices, CACHE_ROWS,
        ranking=tr.weights.vertex_weight, mode="distributed",
        partition_assignment=tr.partition.assignment)
    served = {}
    for mode, cache, block, plan_c, miss in (
        ("partitioned", tr.cache, tr.cache_block, cp, batch.feats),
        ("distributed", distributed,
         torch.as_tensor(distributed.build_resident(papers.features), device=dev),
         None, None),
    ):
        if plan_c is None:
            plan_c = cache.build_plan(plan)
            miss = plan_io.gather_miss_features(plan_c, papers.features, pin=True)
        got = sim_serve_features(
            block, plan_io.cache_plan_to_device(plan_c, dev),
            plan_io.pad_rows(miss.to(dev, non_blocking=True), plan_c.max_miss),
        ).cpu()
        check(got[valid].numpy().tobytes() == want[valid].numpy().tobytes()
              and not got[~valid].any(),
              f"cache {mode}: the served block differs from the host gather")
        bd = plan_c.breakdown()
        check((bd.remote_hit > 0) == (mode == "distributed"),
              f"cache {mode}: {bd.remote_hit} remote hits")
        served[mode] = {"local_hit": bd.local_hit, "remote_hit": bd.remote_hit,
                        "host_miss": bd.host_miss, "input_rows": bd.total,
                        "miss_width": plan_c.max_miss, "send_width": plan_c.max_send,
                        "resident_block_bytes": block.numel() * 4}
    emit("cache_served", {"rows_per_split": CACHE_ROWS, "first_batch": served,
                          "valid_rows_byte_equal": True, "padding_rows_zero": True})

    # (c) pinned feature bytes of the first batches, with the cache and without
    feat_bytes = {"cached": [], "full": []}
    for i, targets in enumerate(tr.sampler.epoch_targets(0)[:3]):
        for key, serve in (("cached", True), ("full", False)):
            tr.producer.serve_cache = serve
            feat_bytes[key].append(tr.producer.build(0, i, targets).feats.nbytes)
    tr.producer.serve_cache = True

    # (b) cached runs: bitwise the uncached losses
    expect = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
              "shuffle_bwd")
    runs = {}
    for source, plain in (("serial", serial), ("device_pipelined", device_pipelined)):
        launches, _, stats, runs[source] = run_trainer(
            papers, spec, replace(ccfg, plan_source=source), dev, 3,
            f"sage cache, {source} source",
            expect + (("wavefront_expand",) if source != "serial" else ()),
            epochs=2)
        for k in total:
            total[k] += launches[k]
        check(runs[source] == plain[:6],
              f"cache: {source} losses {runs[source]} != uncached {plain[:6]}")
    totals = stats[-1].totals()
    emit("cache", {
        "rows_per_split": CACHE_ROWS, "cached_equals_uncached": True,
        "last_epoch_breakdown": {k: totals[k] for k in (
            "load_local_hit", "load_remote_hit", "load_host_miss", "loaded_rows")},
        "pinned_feature_bytes": feat_bytes,
        "resident_block_bytes": tr.cache_block.numel() * 4,
    })
    del tr

    # (d) overlap and the cache on the device sources
    ocfg = replace(ccfg, shuffle_overlap=True, shuffle_chunks=4)
    both = {}
    for source in ("device", "device_pipelined"):
        launches, _, _, both[source] = run_trainer(
            papers, spec, replace(ocfg, plan_source=source), dev, 3,
            f"sage overlap + cache, {source} source",
            expect + ("wavefront_expand",))
        for k in total:
            total[k] += launches[k]
    check(both["device"] == both["device_pipelined"],
          f"overlap + cache: device and device_pipelined differ {both}")

    # (e) the staged window with overlap and the cache
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.profile_step", "--plan-source",
         "pipelined", "--overlap-chunks", "4", "--cache-mode", "partitioned",
         "--cache-capacity", str(CACHE_ROWS)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    check(proc.returncode == 0,
          f"cache: profile_step failed ({proc.returncode}): {proc.stderr[-2000:]}")
    prof = _json.loads(proc.stdout.strip().splitlines()[-1])["profile"]
    copies, steps = prof["h2d_copies"], prof["steps"]
    check("pageable" not in copies,
          f"cache: pageable host-to-device copies in the steps: {copies}")
    pinned = copies.get("pinned", {"count": 0, "device_ms": 0.0})
    check(pinned["count"] == 2 * steps,
          f"cache: {pinned['count']} pinned copies for {steps} steps")
    emit("cache_staging", {
        "device_equals_device_pipelined": True, "overlap_chunks": 4,
        "h2d_copies": copies, "pinned_copies_per_step": pinned["count"] / steps,
        "window_wall_ms": prof["wall_ms"], "window_device_ms": prof["device_ms"],
        "device_idle_share": prof["device_idle_share"],
        "wait_ms": prof["wait_ms"], "stage_ms": prof["stage_ms"],
        "device_sync_ms": prof["device_sync_ms"],
        "resident_bytes": prof["resident_bytes"],
    })


def replicated_first_batch(first):
    """The first papers-s batch built with the replication set the trainer
    selects at ``REP_BUDGET`` (the same assignment and presample weights),
    with its edge halves, repadded from empty marks like ``first.plan``; and
    the set."""
    from repro_torch.core import build_split_plan, repad_plan, select_replication

    rep = select_replication(first.ds.graph, 4, first.part.assignment,
                             first.weights, REP_BUDGET)
    plan = build_split_plan(first.sampler.sample_batch(first.targets, 0, 0),
                            first.part.assignment, 4, pad_multiple=-1,
                            with_halves=True, replication=rep)
    return repad_plan(plan, {}), rep


def replication_parity(dev, first, plan, rep):
    """Phase 15a: the first batch with and without replication on the card:
    blocking SAGE and GCN bitwise (logits, loss, gradients), GAT within
    2e-5 (loss) and 5e-4 (gradients, ``scaled_close``); overlap at 4 chunks
    with replication within 5e-5 / 3e-4 of blocking with replication."""
    from dataclasses import replace

    import torch

    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train import plan_io

    R = rep.num_replicated
    pa0 = plan_io.plan_to_device(first.plan, dev, with_halves=True)
    pa1 = plan_io.plan_to_device(plan, dev, with_halves=True, num_replicated=R)
    feats = torch.as_tensor(plan_io.load_features(plan, first.ds.features),
                            device=dev)
    check(torch.equal(feats.cpu(), torch.as_tensor(
        plan_io.load_features(first.plan, first.ds.features))),
          "replication: the input rows changed")
    labels = torch.as_tensor(plan_io.load_labels(plan, first.ds.labels),
                             device=dev)
    rep_block = torch.as_tensor(first.ds.features[rep.vertices], device=dev)
    out = {}
    for model in ("sage", "gcn", "gat"):
        spec = GNNSpec(model=model, num_heads=4)
        gnn = GNN(spec, generator=torch.Generator().manual_seed(0)).to(dev)
        o0, l0, g0 = fwd_grads(spec, gnn, feats, pa0, labels)
        o1, l1, g1 = fwd_grads(spec, gnn, feats, pa1, labels, rep_block)
        row = {}
        if model == "gat":
            dl = abs(float(l1) - float(l0))
            check(dl <= 2e-5 * max(1.0, abs(float(l0))),
                  f"replication gat: loss {float(l1)} vs {float(l0)}")
            row["loss_abs_diff"] = dl
            row["grads"] = [scaled_close(f"replication gat grad {i}", a, b,
                                         GAT_REP_TOL)
                            for i, (a, b) in enumerate(zip(g1, g0, strict=True))]
        else:
            check(torch.equal(o1, o0) and torch.equal(l1, l0)
                  and all(torch.equal(a, b) for a, b in zip(g1, g0, strict=True)),
                  f"replication {model}: replicated and unreplicated differ")
            row["bitwise_equal"] = True
        o2, _, g2 = fwd_grads(replace(spec, overlap=True, shuffle_chunks=4),
                              gnn, feats, pa1, labels, rep_block)
        row["overlap_chunks4"] = {
            "logits": scaled_close(f"replication {model} overlap logits", o2,
                                   o1, OVERLAP_TOL),
            "grads": [scaled_close(f"replication {model} overlap grad {i}",
                                   a, b, ADJ_TOL)
                      for i, (a, b) in enumerate(zip(g2, g1, strict=True))]}
        out[model] = row
    return out


def layout_kernels(dev, plan, name):
    """The three gather_segsum kernels (and the row adjoint's walk) at every
    layer of ``plan``, whose mixed rows are [local][recv][replicated]
    (M = n_local + P*S + R: S = 0 in dp, R > 0 only at a replicated input
    layer): the unweighted forward and row adjoint at the layer's width
    (SAGE's and GCN's: 128 at the input layer, 256 above) and GAT's at 4
    heads x 64 (weighted forward, row and weight adjoints), bitwise against
    their plain versions on a CPU copy."""
    import torch

    from repro_torch.kernels.gather_segsum import kernel, ops, ref
    from repro_torch.kernels.gather_segsum.layout import AGG_ROWS as R

    def on_cpu(fn, *args):
        return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))

    P, nl = plan.num_devices, plan.num_layers
    gen = torch.Generator(device=dev).manual_seed(15)
    H = 4
    detail = []
    for li, lp in enumerate(plan.layers):
        F = 128 if li == nl - 1 else 256
        M = lp.n_local + P * lp.send_idx.shape[2] + lp.num_replicated
        num_out = lp.self_pos.shape[1]
        pd = torch.as_tensor(lp.pack_dst, device=dev)
        pack_src = ops._pack_src(torch.as_tensor(lp.edge_src, device=dev),
                                 torch.as_tensor(lp.pack_perm, device=dev), pd, M)
        rows = torch.randn(P, M, F, device=dev, generator=gen)
        g_rows = torch.randn(P, num_out, F, device=dev, generator=gen)
        wide = torch.randn(P, M, 256, device=dev, generator=gen)
        g = torch.randn(P, num_out, 256, device=dev, generator=gen)
        w = torch.randn(P, pd.shape[1] * pd.shape[2], H, device=dev,
                        generator=gen)
        csr = kernel.src_sorted_csr(pack_src, pd, M, num_out)
        for got, want in zip(csr, on_cpu(ref.src_sorted_csr_ref, pack_src, pd,
                                         M, num_out), strict=True):
            check(torch.equal(got.cpu(), want),
                  f"{name} layer {li}: walk differs")
        checks = {
            "gather_segsum_fwd": (
                kernel.gather_segsum_fwd(rows, pack_src, pd, None, num_out),
                on_cpu(ref.gather_segsum_fwd_packed, rows, pack_src, pd, None,
                       num_out)),
            "gather_segsum_bwd_mixed": (
                kernel.gather_segsum_bwd_mixed(g_rows, pack_src, pd, None, M,
                                               csr),
                on_cpu(ref.gather_segsum_bwd_mixed_packed, g_rows, pack_src,
                       pd, None, M)),
            "gather_segsum_fwd, weighted": (
                kernel.gather_segsum_fwd(wide, pack_src, pd, w, num_out),
                on_cpu(ref.gather_segsum_fwd_packed, wide, pack_src, pd, w,
                       num_out)),
            "gather_segsum_bwd_mixed, weighted": (
                kernel.gather_segsum_bwd_mixed(g, pack_src, pd, w, M, csr),
                on_cpu(ref.gather_segsum_bwd_mixed_packed, g, pack_src, pd, w,
                       M)),
            "gather_segsum_bwd_w": (
                kernel.gather_segsum_bwd_w(wide, g, pack_src, pd, H),
                on_cpu(ref.gather_segsum_bwd_w_packed, wide, g, pack_src, pd,
                       H)),
        }
        for kname, (got, want) in checks.items():
            check(torch.equal(got.cpu(), want),
                  f"{name} layer {li}: {kname} differs from its plain version")
        valid = pd < R
        detail.append({
            "layer": li, "P": P, "M": M, "F": F, "n_local": lp.n_local,
            "S": lp.send_idx.shape[2], "replicated_rows": lp.num_replicated,
            "num_out": num_out, "DB": pd.shape[1], "EB": pd.shape[2],
            "valid_slots": int(valid.sum()),
            "replicated_slots": int(((pack_src >= M - lp.num_replicated)
                                     & valid).sum()) if lp.num_replicated else 0,
            "bitwise_vs_cpu": sorted(checks)})
    emit("kernel_detail", {"name": f"{name}_layers", "layers": detail})


def self_rows_adjoint(dev, plan, layer, name, F=256):
    """``shuffle_bwd`` as the self rows' adjoint at ``layer`` of ``plan``
    (one group: each split's destinations among its M mixed rows), with a
    cotangent that is zero past each split's destination count, as on the
    path; bitwise against its plain version on a CPU copy."""
    import torch

    from repro_torch.kernels.shuffle import kernel as sh
    from repro_torch.kernels.shuffle import ref

    lp = plan.layers[layer]
    P, S = plan.num_devices, lp.send_idx.shape[2]
    M = lp.n_local + P * S + lp.num_replicated
    self_pos = torch.as_tensor(lp.self_pos, device=dev)[:, None, :].contiguous()
    dst_count = torch.as_tensor(plan.node_count[layer],
                                device=dev)[:, None].contiguous()
    n_dst = self_pos.shape[2]
    gen = torch.Generator(device=dev).manual_seed(16)
    live = torch.arange(n_dst, device=dev)[None, None, :] < dst_count[:, :, None]
    g = torch.randn(P, 1, n_dst, F, device=dev, generator=gen) * live[..., None]
    got = sh.shuffle_bwd(g, self_pos, dst_count, M)
    want = ref.shuffle_bwd(g.cpu(), self_pos.cpu(), dst_count.cpu(), M)
    check(torch.equal(got.cpu(), want),
          f"{name} layer {layer}: the self rows' shuffle_bwd differs from its "
          "plain version")
    emit("kernel_detail", {
        "name": f"{name}_self_rows", "kernel": "shuffle_bwd", "layer": layer,
        "P": P, "M": M, "S": S, "N": n_dst, "F": F,
        "live_rows": int(plan.node_count[layer].sum()), "bitwise_vs_cpu": True})


def replication_phase(dev, first, cfg, serial, split_iters, device_pipelined,
                      total):
    """Phase 15: hot-vertex replication at ``REP_BUDGET``. ``serial`` and
    ``split_iters`` are phase 4's serial losses and steps, ``device_pipelined``
    phase 7's losses; the runs' launches are added to ``total``."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import Trainer, modeled_wire_bytes

    plan, rep = replicated_first_batch(first)
    check(plan.layers[-1].num_replicated == rep.num_replicated > 0,
          "replication: the input layer has no replicated region")
    sage = GNNSpec(model="sage")
    first_batch = {
        name: {"shuffle_rows": p.shuffle_rows(),
               "cross_edge_fraction": p.cross_edge_fraction(),
               "wire_bytes_sage": modeled_wire_bytes(p, sage, "float32"),
               "input_layer_send_width": p.layers[-1].send_idx.shape[2]}
        for name, p in (("unreplicated", first.plan), ("replicated", plan))}
    check(first_batch["replicated"]["shuffle_rows"]
          < first_batch["unreplicated"]["shuffle_rows"],
          f"replication: shuffle rows did not fall {first_batch}")
    parity = replication_parity(dev, first, plan, rep)
    layout_kernels(dev, plan, "replicated")
    emit("replication_parity", {
        "replicated_rows": rep.num_replicated, "budget_rows": rep.budget_rows,
        "resident_bytes": rep.num_replicated * first.ds.features.shape[1] * 4,
        "first_batch": first_batch, "models": parity,
        # the split-quality counters the trainer reads after every step, on
        # the host: one pass over the replicated first batch's edge masks
        "edge_accounting_ms": host_ms(plan.edge_accounting, calls=20),
        "tolerance": {"gat_loss": 2e-5, "gat_grads": GAT_REP_TOL,
                      "overlap_logits": OVERLAP_TOL, "overlap_grads": ADJ_TOL}})

    rcfg = replace(cfg, replication_budget=REP_BUDGET)
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
            "shuffle_bwd")
    # (b) the serial source: phase 4's losses bit for bit, fewer wire bytes
    # and a lower cross-edge fraction at every step
    launches, tr, stats, losses = run_trainer(
        first.ds, sage, replace(rcfg, plan_source="serial"), dev, 3,
        "sage replication, serial source", both, epochs=2)
    for k in total:
        total[k] += launches[k]
    check(tr.replication.num_replicated == rep.num_replicated,
          "replication: the trainer selected another set")
    check(losses == serial[:6],
          f"replication: losses {losses} != unreplicated {serial[:6]}")
    iters = [it for e in stats for it in e.iters]
    for a, b in zip(iters, split_iters[:6], strict=True):
        check(a.wire_bytes < b.wire_bytes
              and a.cross_edge_fraction < b.cross_edge_fraction,
              f"replication: wire {a.wire_bytes} vs {b.wire_bytes}, cross "
              f"{a.cross_edge_fraction} vs {b.cross_edge_fraction}")
    # (c) the device sources, bitwise equal, and equal to phase 7's losses
    dev_losses = {}
    for source in ("device", "device_pipelined"):
        launches, _, _, dev_losses[source] = run_trainer(
            first.ds, sage, replace(rcfg, plan_source=source), dev, 3,
            f"sage replication, {source} source", both + ("wavefront_expand",),
            epochs=2)
        for k in total:
            total[k] += launches[k]
    check(dev_losses["device"] == dev_losses["device_pipelined"]
          == device_pipelined[:6],
          f"replication: device sources differ {dev_losses} "
          f"(unreplicated {device_pipelined[:6]})")
    # (d) telemetry, refinement after epoch 1, an epoch on the rebuilt sampler
    tr = Trainer(first.ds, sage, replace(rcfg, plan_source="device",
                                         record_telemetry=True), device=dev)
    e1 = tr.train_epoch(max_iters=3)
    graph = first.ds.graph
    w_e = tr.telemetry.as_weights().edge_weight + 1e-9
    before = {"cut": tr.partition.cut_weight(graph, w_e),
              "replicated_rows": tr.replication.num_replicated,
              "cross_edge_fraction": [it.cross_edge_fraction for it in e1.iters]}
    t0 = time.perf_counter()
    part = tr.refine_partition()
    t_refine = time.perf_counter() - t0
    moved = int((part.assignment != first.part.assignment).sum())
    reset_launches()
    e2 = tr.train_epoch(max_iters=3)
    launches = read_launches()
    for k in total:
        total[k] += launches[k]
    after = {"cut": part.cut_weight(graph, w_e),
             "replicated_rows": tr.replication.num_replicated,
             "cross_edge_fraction": [it.cross_edge_fraction for it in e2.iters]}
    check(after["cut"] <= before["cut"],
          f"refine: the weighted cut rose {before['cut']} -> {after['cut']}")
    runs = tr.device_sampler.stats()["sampler_batches"]
    check(runs == 3 and launches["wavefront_expand"] == L * runs,
          f"refine: {launches['wavefront_expand']} wavefront launches for "
          f"{runs} sampling runs")
    losses = [it.loss for it in e2.iters]
    check(all(np.isfinite(losses)), f"refine: non-finite losses {losses}")
    emit("refine_partition", {
        "before": before, "after": after, "moved_vertices": moved,
        "refine_s": t_refine, "telemetry_batches": tr.telemetry.num_batches,
        "epoch2_losses": losses, "epoch2_launches": launches,
        "sampler": tr.device_sampler.stats()})


def dp_phase(first, cfg, dev, split_iters, total):
    """Phase 16: dp and pushpull at phase 4's widths, P = 4 micro-batches of
    256. ``split_iters`` are phase 4's serial steps; the runs' launches are
    added to ``total``."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.core import build_dp_plan, repad_plan
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import Trainer

    papers = first.ds
    # the first dp batch as the trainer builds it (keyed micro-batches,
    # repadded from empty marks): the kernels at its layout (S = 0, dp's
    # larger N), the self rows' adjoint at layer 1
    plan = repad_plan(build_dp_plan(
        first.sampler.sample_micro_batch(first.targets, 4, 0, 0),
        pad_multiple=cfg.pad_multiple), {})
    check(all(lp.send_idx.shape[2] == 0 for lp in plan.layers),
          "dp: the first batch's plan sends rows")
    layout_kernels(dev, plan, "dp")
    self_rows_adjoint(dev, plan, 1, "dp")
    dcfg = replace(cfg, mode="dp")
    sage = GNNSpec(model="sage")
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
            "shuffle_bwd")
    losses, iters = {}, {}
    for name, c in (("dp, serial", dcfg),
                    ("dp, pipelined", replace(dcfg, plan_source="pipelined")),
                    ("pushpull, serial", replace(dcfg, mode="pushpull"))):
        launches, _, stats, losses[name] = run_trainer(
            papers, sage, c, dev, 3, f"sage {name} source", both, epochs=2)
        iters[name] = [it for e in stats for it in e.iters]
        for k in total:
            total[k] += launches[k]
    check(losses["dp, serial"] == losses["dp, pipelined"]
          == losses["pushpull, serial"],
          f"dp: serial, pipelined and pushpull losses differ {losses}")
    for model, expect in (("gcn", both[:3]),
                          ("gat", both + ("gather_segsum_bwd_w",))):
        launches, _, _, _ = run_trainer(papers, GNNSpec(model=model, num_heads=4),
                                        dcfg, dev, 2, f"{model} dp", expect)
        for k in total:
            total[k] += launches[k]
        check(model != "gcn" or launches["shuffle_bwd"] == 0,
              f"dp gcn: {launches['shuffle_bwd']} shuffle_bwd launches")
    try:
        Trainer(papers, sage, replace(dcfg, plan_source="device"), device=dev)
    except ValueError as e:
        refused = str(e)
    else:
        raise RuntimeError("dp: plan_source='device' did not raise")

    def summary(its):
        step_ms = [1e3 * (it.t_wait + it.t_stage + it.t_device) for it in its]
        return {k: [getattr(it, k) for it in its] for k in (
            "loaded_rows", "computed_edges", "shuffle_rows", "load_imbalance",
            "busiest_edges", "cross_edge_fraction")} | {"step_ms": step_ms}

    dp, split = summary(iters["dp, serial"]), summary(split_iters[:6])
    check(dp["loaded_rows"][0] == plan.loaded_feature_rows(),
          f"dp: the first step loaded {dp['loaded_rows'][0]} rows, the held "
          f"layout {plan.loaded_feature_rows()}")
    check(sum(split["loaded_rows"]) < sum(dp["loaded_rows"]),
          "dp: split loaded no fewer rows than dp")
    check(all(r == 0 for r in dp["shuffle_rows"]), "dp: rows were shuffled")
    emit("dp_vs_split", {
        "micro_batch": cfg.batch_size // cfg.num_devices,
        "serial_equals_pipelined_equals_pushpull": True,
        "device_source_refused": refused,
        "dp": dp, "split": split,
        "loaded_rows_ratio": float(np.sum(dp["loaded_rows"])
                                   / np.sum(split["loaded_rows"])),
        "computed_edges_ratio": float(np.sum(dp["computed_edges"])
                                      / np.sum(split["computed_edges"])),
    })
    return losses["dp, serial"]


def send_adjoint(dev, plan, layer, name, F):
    """``shuffle_bwd`` as the send gather's adjoint at ``layer`` of ``plan``
    (the cotangent zero at the padding slots, as on the path), bitwise
    against its plain version on a CPU copy."""
    import torch

    from repro_torch.kernels.shuffle import kernel as sh
    from repro_torch.kernels.shuffle import ref

    lp = plan.layers[layer]
    P, _, S = lp.send_idx.shape
    idx = torch.as_tensor(lp.send_idx, device=dev)
    count = torch.as_tensor(lp.send_count, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    valid = torch.arange(S, device=dev)[None, None, :] < count[:, :, None]
    g = torch.randn(P, P, S, F, device=dev, generator=gen) * valid[..., None]
    got = sh.shuffle_bwd(g, idx, count, lp.n_local)
    want = ref.shuffle_bwd(g.cpu(), idx.cpu(), count.cpu(), lp.n_local)
    check(torch.equal(got.cpu(), want),
          f"{name} layer {layer}: the send's shuffle_bwd differs from its "
          "plain version")
    emit("kernel_detail", {
        "name": f"{name}_send", "kernel": "shuffle_bwd", "layer": layer,
        "P": P, "N": lp.n_local, "S": S, "F": F,
        "valid_slots": int(lp.send_count.sum()), "bitwise_vs_cpu": True})


def replica_wavefront(dev, first, replica, R):
    """The device sampler under the replica-keyed counter (``batch * R +
    replica``) on replica ``replica``'s chunk of the first batch: the
    wavefront expansion at every hop bitwise against its plain version, and
    the card's ``sample_batch`` bitwise against a CPU sampler's and against
    the flattened counter's draw."""
    import numpy as np
    import torch

    from repro_torch.sampler import DeviceSampler
    from repro_torch.sampler import kernel as wf
    from repro_torch.sampler import ref
    from repro_torch.sampler.engine import _sample_device, frontier_degrees

    eng = DeviceSampler(first.ds.graph, first.part.assignment, 4, FANOUTS, 0,
                        host_sampler=first.sampler, device=dev)
    chunk = np.array_split(first.targets, R)[replica]
    flat = 0 * R + replica  # batch 0's flattened counter
    t_dev, keys = eng.device_inputs(chunk, 0, flat)
    fronts, counts, _, _ = _sample_device(
        eng._dev, t_dev, len(chunk), keys, caps=eng.caps_tuple(),
        fanouts=FANOUTS)
    rows = []
    for layer, fanout in enumerate(FANOUTS):
        _, _, deg = frontier_degrees(eng._dev, fronts[layer], counts[layer])
        vid, deg, key = fronts[layer].reshape(-1), deg.reshape(-1), keys[layer]
        got = wf.wavefront_expand(vid, deg, key, fanout)
        want = ref.expand_codes(vid, deg, key[0], key[1], fanout)
        check(torch.equal(got, want),
              f"mesh: wavefront_expand at hop {layer} of replica {replica} "
              "differs from its plain version")
        rows.append({"layer": layer, "rows": vid.numel(),
                     "valid_rows": int((deg >= 0).sum()), "fanout": fanout})
    cpu = DeviceSampler(first.ds.graph, first.part.assignment, 4, FANOUTS, 0,
                        host_sampler=first.sampler, device="cpu")
    cpu._caps = dict(eng._caps)
    a = eng.sample_batch(chunk, 0, 0, replica=replica, num_replicas=R)
    check(eng.stats()["sampler_fallbacks"] == 0,
          "mesh: the replica-keyed sample fell back to the host")
    for other in (cpu.sample_batch(chunk, 0, 0, replica=replica, num_replicas=R),
                  eng.sample_batch(chunk, 0, flat)):
        for la, lb in zip(a.layers, other.layers, strict=True):
            for f in ("src", "dst", "edge_id"):
                check(np.array_equal(getattr(la, f), getattr(lb, f)),
                      f"mesh: replica-keyed samples differ in {f}")
        for fa, fb in zip(a.frontiers, other.frontiers, strict=True):
            check(np.array_equal(fa, fb), "mesh: replica-keyed frontiers differ")
    emit("kernel_detail", {
        "name": "mesh_wavefront_expand", "replica": replica, "R": R,
        "key_batch": flat, "targets": len(chunk), "hops": rows,
        "bitwise_vs_plain": True,
        "sample_batch": "card == cpu == flattened counter, bitwise"})


def mesh_phase(first, cfg, dev, serial, split_iters, dp_losses, total):
    """Phase 17: the 2-D (replica, split) mesh in sim form at phase 4's
    widths. ``serial`` and ``split_iters`` are phase 4's serial losses and
    steps, ``dp_losses`` phase 16's serial dp losses; the runs' launches are
    added to ``total``."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.core import build_split_plan, repad_plan
    from repro_torch.models.gnn import GNNSpec

    papers = first.ds
    sage = GNNSpec(model="sage")
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
            "shuffle_bwd")

    def run(c, name, expect=both):
        launches, tr, stats, losses = run_trainer(papers, sage, c, dev, 3,
                                                  name, expect, epochs=2)
        for k in total:
            total[k] += launches[k]
        return launches, tr, [it for e in stats for it in e.iters], losses

    # (a) R = 1: phase 4's serial losses bit for bit
    _, _, r1_iters, r1 = run(replace(cfg, num_replicas=1), "sage mesh R=1, serial")
    check(r1 == serial[:6], f"mesh R=1: losses {r1} != 1-D {serial[:6]}")

    # (d) the kernels at replica 1's first R = 2 batch, as the trainer builds
    # it: keyed chunks, both parts repadded twice from empty marks
    plans = [build_split_plan(s, first.part.assignment, 4,
                              pad_multiple=cfg.pad_multiple)
             for s in first.sampler.sample_micro_batch(first.targets, 2, 0, 0)]
    marks = {}
    for _ in range(2):
        for p in plans:
            repad_plan(p, marks)
    layout_kernels(dev, plans[1], "mesh_replica1")
    for li in range(L):
        F = 128 if li == L - 1 else 256
        send_adjoint(dev, plans[1], li, "mesh_replica1", F)
        self_rows_adjoint(dev, plans[1], li, "mesh_replica1", F)
    replica_wavefront(dev, first, 1, 2)

    # (b) R = 2, 512 targets a replica, on all four sources
    r2_iters, r2 = {}, {}
    for source in ("serial", "pipelined", "device", "device_pipelined"):
        expect = both + (("wavefront_expand",) if "device" in source else ())
        launches, tr, r2_iters[source], r2[source] = run(
            replace(cfg, num_replicas=2, plan_source=source),
            f"sage mesh R=2, {source}", expect)
        if "device" in source:
            sampled = tr.device_sampler.stats()["sampler_batches"]
            check(sampled == 2 * 6
                  and launches["wavefront_expand"] == L * sampled,
                  f"mesh {source}: {launches['wavefront_expand']} wavefront "
                  f"launches for {sampled} replica samples")
    check(r2["serial"] == r2["pipelined"],
          f"mesh R=2: serial and pipelined losses differ {r2}")
    check(r2["device"] == r2["device_pipelined"],
          f"mesh R=2: device and device_pipelined losses differ {r2}")
    first_rows = sum(p.loaded_feature_rows() for p in plans)
    check(r2_iters["serial"][0].loaded_rows == first_rows,
          f"mesh R=2: the first step loaded {r2_iters['serial'][0].loaded_rows}"
          f" rows, the held parts {first_rows}")

    # (c) R x 1: R = 4 groups of P = 1, 256 targets a replica, against dp
    # over 4 devices (the same keyed micro-batches)
    _, _, _, rx1 = run(replace(cfg, num_replicas=4, num_devices=1),
                       "sage mesh R=4 x P=1, serial")
    np.testing.assert_allclose(rx1, dp_losses, **MESH_DP_TOL)

    def summary(its):
        return {k: [getattr(it, k) for it in its] for k in (
            "loss", "loaded_rows", "shuffle_rows", "computed_edges")} | {
            "step_ms": [1e3 * (it.t_wait + it.t_stage + it.t_device)
                        for it in its],
            "wait_ms": [1e3 * it.t_wait for it in its],
            "stage_ms": [1e3 * it.t_stage for it in its],
            "sync_ms": [1e3 * it.t_device for it in its]}

    r1_rows = sum(it.loaded_rows for it in split_iters[:6])
    emit("mesh_vs_split", {
        "r1_equals_1d": True, "r2_serial_equals_pipelined": True,
        "r2_device_equals_device_pipelined": True,
        "rx1_vs_dp": {"mesh": rx1, "dp": dp_losses, "tolerance": MESH_DP_TOL,
                      "max_abs_diff": float(np.max(np.abs(
                          np.subtract(rx1, dp_losses))))},
        "phase4_r0": summary(split_iters[:6]), "r1": summary(r1_iters),
        "r2": {k: summary(v) for k, v in r2_iters.items()},
        "loaded_rows_ratio_r2_r1": sum(it.loaded_rows for it in
                                       r2_iters["serial"]) / r1_rows,
        "shuffle_rows_ratio_r2_r1": sum(it.shuffle_rows for it in
                                        r2_iters["serial"])
        / sum(it.shuffle_rows for it in split_iters[:6]),
        "memory": {k: v for k, v in MEMORY.items()
                   if k.startswith("sage mesh") or k == "sage, serial source"},
    })
    return r2["serial"]


def checkpoint_phase(first, cfg, dev, clean, final, mesh_r2, gat, total):
    """Phase 18: checkpoint and resume at phase 4's widths. ``clean`` holds
    the clean losses by source (phase 4's and phase 7's, 3 epochs of 3
    steps), ``final`` phase 4's serial run's final params and Adam slots on
    the host, ``mesh_r2`` phase 17's R = 2 serial losses (2 epochs of 3) and
    ``gat`` phase 5's GAT losses (2 epochs of 2); every run's launches are
    checked and added to ``total``."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.core.presample import presample
    from repro_torch.faults import (
        CheckpointError,
        FaultAction,
        FaultInjected,
        FaultInjector,
        corrupt_checkpoint,
        truncate_checkpoint,
    )
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.checkpoint import list_checkpoints
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    papers = first.ds
    sage, gat_spec = GNNSpec(model="sage"), GNNSpec(model="gat", num_heads=4)
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
            "shuffle_bwd")
    saves_ms, resumes_ms, steps_ms, trainers = [], [], [], []
    phase_launches = dict.fromkeys(total, 0)

    def timed_saves(tr):
        """Time each of ``tr``'s saves (D2H, npz, sha256, two fsyncs and
        renames) on the host clock."""
        save = tr.save_checkpoint

        def timed(**kw):
            t0 = time.perf_counter()
            path = save(**kw)
            saves_ms.append(1e3 * (time.perf_counter() - t0))
            return path

        tr.save_checkpoint = timed
        return tr

    def counted(tr, name, spec, expect, fn):
        """Run ``fn`` on ``tr`` with the launch counts at 0, check them
        against the optimizer steps it took and add them to ``total``."""
        reset_launches()
        step0 = tr.global_step
        out = fn()
        launches = read_launches()
        check_launches(name, launches, expect, tr.cfg, spec.model,
                       tr.global_step - step0)
        for k in total:
            total[k] += launches[k]
            phase_launches[k] += launches[k]
        return out

    def kill_and_resume(c, spec, name, expect, steps, kill_epoch=1):
        """A run killed at (``kill_epoch``, 1) and a fresh trainer resumed
        from its checkpoints; returns the resumed trainer and checkpoint."""
        trainers.append(name)
        inj = FaultInjector([FaultAction("kill", epoch=kill_epoch, batch=1)])
        tr = timed_saves(Trainer(papers, spec, c, device=dev, injector=inj))

        def until_killed():
            for _ in range(kill_epoch):
                tr.train_epoch(max_iters=steps)
            try:
                tr.train_epoch(max_iters=steps)
            except FaultInjected:
                return True
            return False

        check(counted(tr, f"{name} killed", spec, expect, until_killed),
              f"checkpoint {name}: the kill at ({kill_epoch}, 1) did not fire")
        del tr
        trainers.append(name)
        tr = timed_saves(Trainer(papers, spec, c, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck = tr.resume()
        torch.cuda.synchronize()
        resumes_ms.append(1e3 * (time.perf_counter() - t0))
        check(ck is not None and (tr._epoch, tr._start_iter) == (kill_epoch, 1),
              f"checkpoint {name}: resumed at ({tr._epoch}, {tr._start_iter})")
        if tr.device_sampler is not None:
            check(tr.device_sampler.export_state() == ck.cursor["sampler"],
                  f"checkpoint {name}: the sampler state was not restored")
        return tr, ck

    def resumed_losses(tr, name, spec, expect, steps, epochs):
        def run():
            its = [it for _ in range(epochs)
                   for it in tr.train_epoch(max_iters=steps).iters]
            steps_ms.extend(1e3 * (it.t_wait + it.t_stage + it.t_device)
                            for it in its)
            return [it.loss for it in its]
        return counted(tr, f"{name} resumed", spec, expect, run)

    def final_state_equal(tr):
        return all(torch.equal(a.cpu(), b) for a, b in
                   zip(tr._opt_tensors(), final, strict=True))

    def save_breakdown(tr, root, repeats=5):
        """A save's parts on the host clock, each the median of
        ``repeats``: the D2H reads, ``np.savez`` into memory, the sha256
        of its bytes, and writing them to a file with the ``fsync``."""
        import hashlib
        import io

        from repro_torch.train.checkpoint import _flatten, _to_numpy

        tree = [tr._param_tree(), tr._opt_tree()]
        parts = {"d2h": [], "savez": [], "sha256": [], "write_fsync": []}
        for i in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
            t1 = time.perf_counter()
            buf = io.BytesIO()
            np.savez(buf, **flat)
            t2 = time.perf_counter()
            hashlib.sha256(buf.getbuffer()).hexdigest()
            t3 = time.perf_counter()
            with open(os.path.join(root, f"breakdown.{i}"), "wb") as f:
                f.write(buf.getbuffer())
                f.flush()
                os.fsync(f.fileno())
            t4 = time.perf_counter()
            for k, a, b in (("d2h", t0, t1), ("savez", t1, t2),
                            ("sha256", t2, t3), ("write_fsync", t3, t4)):
                parts[k].append(1e3 * (b - a))
        return {k: statistics.median(v) for k, v in parts.items()}

    out = {"sources": {}}
    with tempfile.TemporaryDirectory() as root:
        # (a) the four sources: kill at (1, 1), resume, two more epochs' worth
        for source in ("serial", "pipelined", "device", "device_pipelined"):
            expect = both + (("wavefront_expand",) if "device" in source else ())
            c = replace(cfg, plan_source=source,
                        ckpt_dir=os.path.join(root, source), ckpt_every=1)
            tr, ck = kill_and_resume(c, sage, source, expect, 3)
            losses = resumed_losses(tr, source, sage, expect, 3, 2)
            want = clean[source][4:]
            check(losses == want,
                  f"checkpoint {source}: resumed losses {losses} != {want}")
            bitwise_final = None
            if source in ("serial", "pipelined"):
                bitwise_final = final_state_equal(tr)
                check(bitwise_final, f"checkpoint {source}: final params and "
                      "Adam slots differ from phase 4's serial run")
            out["sources"][source] = {
                "resumed_from": os.path.basename(ck.path),
                "losses": losses, "bitwise_clean_suffix": True,
                "final_state_bitwise_phase4": bitwise_final,
                "sampler_state_restored": "device" in source,
            }
            del tr
        serial_dir = os.path.join(root, "serial")
        out["params_npz_bytes"] = os.path.getsize(
            os.path.join(list_checkpoints(serial_dir)[-1][1], "params.npz"))

        # (b) the R = 2 mesh on the serial source
        c = replace(cfg, num_replicas=2, ckpt_dir=os.path.join(root, "mesh"),
                    ckpt_every=1)
        tr, _ = kill_and_resume(c, sage, "mesh R=2", both, 3)
        losses = resumed_losses(tr, "mesh R=2", sage, both, 3, 1)
        check(losses == mesh_r2[4:],
              f"checkpoint mesh R=2: {losses} != phase 17's {mesh_r2[4:]}")
        out["mesh_r2"] = {"losses": losses, "bitwise_clean_suffix": True}
        del tr

        # (c) GAT, 2 steps an epoch: the weight adjoint on the resumed path
        gat_expect = both + ("gather_segsum_bwd_w",)
        c = replace(cfg, ckpt_dir=os.path.join(root, "gat"), ckpt_every=1)
        tr, _ = kill_and_resume(c, gat_spec, "gat", gat_expect, 2)
        losses = resumed_losses(tr, "gat", gat_spec, gat_expect, 2, 1)
        check(losses == gat[3:],
              f"checkpoint gat: {losses} != phase 5's {gat[3:]}")
        out["gat"] = {"losses": losses, "bitwise_clean_suffix": True}
        del tr

        # (d) corruption: the serial run's newest checkpoint, then all of them
        ckpts = list_checkpoints(serial_dir)
        corrupt_checkpoint(ckpts[-1][1])
        trainers.append("corrupt")
        tr = Trainer(papers, sage, replace(cfg, ckpt_dir=serial_dir), device=dev)
        ck = tr.resume()
        check(ck.step == ckpts[-2][0],
              f"checkpoint corrupt: resumed step {ck.step}, not {ckpts[-2][0]}")
        want = clean["serial"][ck.step:]
        losses = resumed_losses(tr, "corrupt", sage, both, 3, 1)
        check(losses == want and final_state_equal(tr),
              f"checkpoint corrupt: losses {losses} != {want} or final state")
        for _, path in ckpts:
            truncate_checkpoint(path)
        try:
            tr.resume()
        except CheckpointError as e:
            all_corrupt = str(e)[:160]
        else:
            raise RuntimeError("checkpoint: every checkpoint truncated and "
                               "resume() did not raise")
        out["corrupt_newest"] = {"fell_back_to_step": ck.step,
                                 "losses": losses, "bitwise": True}
        out["all_truncated"] = {"raised": "CheckpointError",
                                "message": all_corrupt}
        out["save_breakdown_ms"] = save_breakdown(tr, root)
        del tr

    # (e) presample at 1 and 4 workers: other streams, each reproducible
    args = (papers.graph, papers.train_ids, list(FANOUTS), cfg.batch_size)
    presample_s, weights = {}, {}
    for workers in (1, 4, 4):
        t0 = time.perf_counter()
        w = presample(*args, num_epochs=2, seed=cfg.seed + 1, workers=workers)
        presample_s.setdefault(workers, []).append(time.perf_counter() - t0)
        weights.setdefault(workers, []).append(w.edge_weight)
    check(not np.array_equal(weights[1][0], weights[4][0]),
          "presample: 1 and 4 workers drew the same weights")
    check(np.array_equal(weights[4][0], weights[4][1]),
          "presample: 4 workers did not repeat bitwise")
    emit("checkpoint", out | {
        "card": CARD, "trainers": len(trainers),
        "wall_s": time.perf_counter() - t_phase, "launches": phase_launches,
        "save_ms": {"median": statistics.median(saves_ms),
                    "max": max(saves_ms), "count": len(saves_ms),
                    "all": saves_ms},
        "resume_ms": resumes_ms,
        "step_ms": {"median": statistics.median(steps_ms), "all": steps_ms},
        "presample_s": {"workers_1": presample_s[1], "workers_4": presample_s[4],
                        "epochs": 2, "weights_differ": True,
                        "workers_4_bitwise_repeat": True},
    })


def counted(device, fn, args):
    """A rank task for ``launch``: ``fn(device, *args)`` with the launch
    counts set to 0 just before and read just after, in the rank's own
    process: ``(result, launches)``."""
    reset_launches()
    out = fn(device, *args)
    return out, read_launches()


def alltoall_rank(device, send, cot, wires, grads):
    """A rank task for phase 19 (a), at world size 1: ``spmd_alltoall`` of
    ``send`` (1, 1, ...) under each wire of ``wires`` with the adjoint of
    ``<out, cot>``, and ``replica_grad_mean`` of ``grads`` at R = 1; host
    arrays ``({wire: (out, adjoint)}, mean)``."""
    from repro_torch.core.shuffle import replica_grad_mean, spmd_alltoall
    from repro_torch.launch.sharding import make_split_mesh

    mesh = make_split_mesh(1, 1)
    out = {}
    for wire in wires:
        s = send.to(device, copy=True).requires_grad_(True)
        y = spmd_alltoall(s[0], mesh.split_group, wire)[None]
        (y * cot.to(device)).sum().backward()
        out[wire] = (y.detach().cpu().numpy(), s.grad.cpu().numpy())
    mean = replica_grad_mean([g.to(device) for g in grads],
                             mesh.replica_group, 1)
    return out, [g.cpu().numpy() for g in mean]


def blocks_equal(a, b):
    """Two samplers' host blocks ``(fronts, counts, layers, flags)`` bit
    for bit."""
    import numpy as np

    return (all(np.array_equal(x, y) for x, y in zip(a[0], b[0], strict=True))
            and all(np.array_equal(x, y)
                    for x, y in zip(a[1], b[1], strict=True))
            and all(np.array_equal(x[k], y[k])
                    for x, y in zip(a[2], b[2], strict=True) for k in y)
            and a[3] == b[3])


def spmd_wavefront(dev, first, sampler):
    """Phase 19 (c)'s checks of the one-split device sampler at the first
    batch: ``wavefront_expand`` at every hop bitwise against its plain
    version, and the card's sample bitwise against ``_sample_device`` on a
    CPU copy of the shards with the same caps. Returns the card's host
    blocks and the hops' shapes."""
    import numpy as np
    import torch

    from repro_torch.sampler import DeviceSampler
    from repro_torch.sampler import kernel as wf
    from repro_torch.sampler import ref
    from repro_torch.sampler.engine import (_sample_device, frontier_degrees,
                                            to_host)

    t_dev, keys = sampler.device_inputs(first.targets, 0, 0)
    caps = sampler.caps_tuple()
    out = _sample_device(sampler._dev, t_dev, len(first.targets), keys,
                         caps=caps, fanouts=FANOUTS)
    fronts, counts = out[0], out[1]
    hops = []
    for layer, fanout in enumerate(FANOUTS):
        _, _, deg = frontier_degrees(sampler._dev, fronts[layer],
                                     counts[layer])
        vid, deg, key = fronts[layer].reshape(-1), deg.reshape(-1), keys[layer]
        check(torch.equal(wf.wavefront_expand(vid, deg, key, fanout),
                          ref.expand_codes(vid, deg, key[0], key[1], fanout)),
              f"spmd: wavefront_expand at hop {layer} of the one-split "
              "sampler differs from its plain version")
        hops.append({"layer": layer, "rows": vid.numel(),
                     "valid_rows": int((deg >= 0).sum()), "fanout": fanout})
    card = to_host(out)
    cpu = DeviceSampler(first.ds.graph, np.zeros(first.ds.graph.num_nodes,
                                                 np.int32),
                        1, list(FANOUTS), 0, host_sampler=first.sampler,
                        device="cpu")
    cpu._caps = dict(sampler._caps)
    t_cpu, keys_cpu = cpu.device_inputs(first.targets, 0, 0)
    check(blocks_equal(card, to_host(_sample_device(
        cpu._dev, t_cpu, len(first.targets), keys_cpu, caps=caps,
        fanouts=FANOUTS))),
        "spmd: the card's one-split sample differs from the CPU's")
    return card, hops


def spmd_phase(first, cfg, dev, total):
    """Phase 19: the spmd form of split parallelism over torch.distributed.
    (a)-(c) run in one rank spawned by ``repro_torch.launch.spmd.launch`` on
    the card at world size 1 over NCCL (a ``FileStore`` rendezvous), its
    tasks' launches counted in its own process and added to ``total``; the
    sim references run here. The kernels are held against their plain
    versions at the one-split batch's layout (``layout_kernels``, the self
    rows' adjoint, the sampler's hops). (d) rehearses four gloo ranks on
    the CPU."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.core import build_split_plan, repad_plan
    from repro_torch.core.shuffle import sim_alltoall
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.launch import spmd
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.sampler import DeviceSampler
    from repro_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    papers = first.ds
    gen = torch.Generator().manual_seed(19)
    # (a) the exchange at a full-width block: 8192 rows of 256 columns
    send = torch.randn(1, 1, 8192, 256, generator=gen)
    cot = torch.randn(1, 1, 8192, 256, generator=gen)
    grads = [torch.randn(256, 256, generator=gen), torch.randn(256, generator=gen)]
    wires = (None, "bfloat16")
    # (b) SAGE and GAT at phase 4's widths and fan-outs, one split
    cfg1 = replace(cfg, num_devices=1)
    specs = {"sage": GNNSpec(model="sage"),
             "gat": GNNSpec(model="gat", num_heads=4)}
    # (c) the cooperative sampler at P = 1 on the first batch's targets
    sampler = DeviceSampler(papers.graph, np.zeros(papers.graph.num_nodes,
                                                   np.int32),
                            1, list(FANOUTS), 0, host_sampler=first.sampler,
                            device=dev)
    t_dev, keys = sampler.device_inputs(first.targets, 0, 0)
    caps = sampler.caps_tuple()
    sample_case = {"shards": sampler.shards, "targets": t_dev.cpu().numpy(),
                   "n_targets": len(first.targets),
                   "layer_keys": keys.cpu().numpy(), "fanouts": list(FANOUTS),
                   "caps": caps}
    tasks = [(counted, (alltoall_rank, (send, cot, wires, grads)))]
    tasks += [(counted, (spmd.train_rank, (papers, spec, cfg1, 1, 3)))
              for spec in specs.values()]
    tasks.append((counted, (spmd.sample_rank, (1, [sample_case]))))
    t0 = time.perf_counter()
    (res,) = spmd.launch(tasks, world=1, timeout_s=600.0)
    t_launch = time.perf_counter() - t0
    ((prim_out, mean), prim_l), *train, (sample_out, sample_l) = res

    # (a) at world 1 the exchange is its own sim form, bit for bit; the
    # replica mean at R = 1 is the identity
    lines = {}
    check(all(np.array_equal(a, b.numpy())
              for a, b in zip(mean, grads, strict=True)),
          "spmd: replica_grad_mean at R = 1 is not the identity")
    lines["replica_grad_mean"] = {"bitwise": True}
    for wire in wires:
        got, got_adj = prim_out[wire]
        s = send.to(dev, copy=True).requires_grad_(True)
        want = sim_alltoall(s, wire)
        (want * cot.to(dev)).sum().backward()
        check(np.array_equal(got, want.detach().cpu().numpy())
              and np.array_equal(got_adj, s.grad.cpu().numpy()),
              f"spmd: spmd_alltoall ({wire}) != sim_alltoall")
        lines[f"alltoall_{wire or 'float32'}"] = {
            "bitwise": True, "bytes": send.numel() * (2 if wire else 4)}

    # (b) the spmd steps bitwise the sim Trainer at num_devices=1
    runs = {}
    expect = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
              "shuffle_bwd")
    for (model, spec), (out, launches) in zip(specs.items(), train,
                                               strict=True):
        tr = Trainer(papers, spec, cfg1, device=dev)
        sim = tr.train_epoch(max_iters=3).iters
        if model == "sage":
            # the first one-split batch as the trainer builds it (repadded
            # from empty marks): M and the edge counts of a whole batch on
            # one split, which no other phase gives the kernels
            plan1 = repad_plan(build_split_plan(
                tr.sampler.sample_batch(tr.sampler.epoch_targets(0)[0], 0, 0),
                tr.partition.assignment, 1, pad_multiple=cfg1.pad_multiple),
                {})
        sim_losses = [it.loss for it in sim]
        check(out["losses"] == sim_losses,
              f"spmd {model}: NCCL losses {out['losses']} != sim {sim_losses}")
        check_launches(f"spmd {model}", launches,
                       expect + (("gather_segsum_bwd_w",) if model == "gat"
                                 else ()), cfg1, model, 3)
        for k in total:
            total[k] += launches[k]
        runs[model] = {
            "losses": out["losses"], "bitwise_sim": True,
            "step_ms": [1e3 * s for s in out["step_s"]],
            "sim_step_ms": [1e3 * (it.t_wait + it.t_stage + it.t_device)
                            for it in sim],
            "launches": {k: v for k, v in launches.items() if v}}
        del tr
    check(all(lp.send_idx.shape[2] == 0 for lp in plan1.layers),
          "spmd: the one-split plan sends rows")
    layout_kernels(dev, plan1, "spmd")
    self_rows_adjoint(dev, plan1, 1, "spmd")

    # (c) the spmd sampler bitwise the device sampler's loop at P = 1, which
    # is bitwise a CPU copy's; the kernel bitwise its plain version per hop
    want, hops = spmd_wavefront(dev, first, sampler)
    check(blocks_equal(sample_out[0]["blocks"], want),
          "spmd: sample_minibatch_spmd != the device sampler's loop")
    check(sample_out[0]["overflow"] == [], "spmd: the sampler overflowed")
    check(sample_l["wavefront_expand"] == L,
          f"spmd: {sample_l['wavefront_expand']} wavefront launches, "
          f"expected {L}")
    for k in total:
        total[k] += prim_l[k] + sample_l[k]

    # (d) the CPU rehearsal: four gloo ranks at P = 4 and on the 2 x 2 mesh
    tiny = make_dataset("tiny")
    rehearsal = {}
    tcfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=16,
                       presample_epochs=2, lr=5e-3)
    cases = {"sage P=4": ("sage", tcfg),
             "gat 2x2": ("gat", replace(tcfg, num_devices=2, num_replicas=2))}
    tasks = []
    for model, c in cases.values():
        spec = GNNSpec(model=model, in_dim=tiny.spec.feat_dim, hidden_dim=64,
                       out_dim=tiny.spec.num_classes, num_layers=2)
        tasks.append((spmd.train_rank, (tiny, spec, c, 1, 3)))
    t0 = time.perf_counter()
    ranks = spmd.launch(tasks, world=4, device="cpu", timeout_s=300.0)
    t_cpu = time.perf_counter() - t0
    for i, (name, (model, c)) in enumerate(cases.items()):
        spec = tasks[i][1][1]
        sim = [it.loss for it in
               Trainer(tiny, spec, c, device="cpu").train_epoch(max_iters=3).iters]
        got = ranks[0][i]["losses"]
        np.testing.assert_allclose(got, sim, rtol=1e-4, atol=1e-6)
        check(all(r[i]["losses"] == got for r in ranks),
              f"spmd rehearsal {name}: the ranks' losses differ")
        rehearsal[name] = {"spmd": got, "sim": sim,
                           "max_abs_diff": float(np.max(np.abs(
                               np.subtract(got, sim))))}
    emit("spmd", {
        "card": CARD, "backend": "nccl", "world": 1, "primitives": lines,
        "train": runs, "sampler": {
            "bitwise_device_loop": True, "card_vs_cpu": "bitwise equal",
            "hops": hops, "wavefront_bitwise_vs_plain": True,
            "wavefront_launches": sample_l["wavefront_expand"]},
        "launch_s": t_launch,
        "rehearsal": {"device": "cpu", "backend": "gloo", "world": 4,
                      "torch": torch.__version__, "runs": rehearsal,
                      "launch_s": t_cpu},
        "phase_s": time.perf_counter() - t_phase,
    })


#: phase 20's models: (arch, depth cut or None, text tokens a prompt; a
#: VLM's patch rows come before them), each served at full width in bf16
FAMILY_RUNS = [
    ("deepseek-v2-lite-16b", None, 1024),
    ("mamba2-2.7b", None, 1024),
    ("hymba-1.5b", None, 1024),
    ("musicgen-medium", None, 1024),
    ("llava-next-mistral-7b", None, 448),
    ("deepseek-v2-236b", 2, 1024),
]
FAMILY_BATCH, FAMILY_NEW = 8, 16
#: DeepSeek-V2-236B's cut: 439 GiB in bf16 at 60 layers, one card holds 80 GB
FAMILY_CUTS = {"deepseek-v2-236b": "depth cut from 60 to 2 layers (the dense "
                                   "lead layer and one MoE layer), widths "
                                   "unchanged: 60 layers are 439 GiB in bf16"}


def _leaves(cache):
    """A layer cache's tensors (a hybrid layer's nest included)."""
    for v in cache.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def counted_generate(model, prompts, patches):
    """``serve.generate`` with the launch counts at 0 just before and read
    just after: (its result, the launches)."""
    import torch

    from repro_torch import serve

    torch.cuda.synchronize()
    reset_launches()
    out = serve.generate(model, prompts, FAMILY_NEW, patches)
    return out, read_launches()


def family_decode_profile(model, prompts, rows, steps=3):
    """Where a decode step of ``model`` goes: ``torch.profiler`` over
    ``steps`` steps (after a warm-up step) against zero caches of the
    phase's length, reduced by ``_decode_trace`` (device ms a step by
    kernel, the decode kernel's share, the device idle share of the traced
    wall, torch calls a step). The profiler's own host cost inflates the
    wall and the idle share; the device times are the kernels' own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer.model import init_caches, make_decode_step

    caches = init_caches(model.cfg, prompts.shape[0], rows + FAMILY_NEW,
                         prompts.device)
    decode = make_decode_step(model.cfg)
    tok = prompts[:, -1:]
    pos = torch.tensor(rows, device=prompts.device)
    with torch.inference_mode():
        decode(model, tok, pos, caches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(steps):
                logits, _ = decode(model, tok, pos + t, caches)
                logits[:, -1].argmax(dim=-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return _decode_trace(prof, wall, steps)


def family_parity(dev, arch):
    """Phase 20 (e): the reduced config of ``arch`` (2 layers, f32), one
    seeded model built on the CPU and copied to the card: prefill and 8
    decode steps, every step's logits within rtol/atol 1e-4 and the greedy
    tokens equal; the decode kernel launched once per attention layer and
    step on the card. An MLA model also decodes with ``opt_mla_absorb``,
    held the same way (no launch), with its largest logit difference from
    the expanded path printed."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.launch.shapes import attention_layers
    from repro_torch.models.transformer.model import init_params

    cfg = serve.serve_config(arch, reduced=True)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(dev)
    prompts = torch.as_tensor(serve.make_prompts(cfg, 4, 16, 0))
    patches = serve.make_patches(cfg, 4, 0)
    patches = None if patches is None else torch.as_tensor(patches)
    reset_launches()
    card = serve.generate(card_model, prompts.to(dev), 9,
                          None if patches is None else patches.to(dev))
    launches = read_launches()
    cpu = serve.generate(cpu_model, prompts, 9, patches)
    check(launches["flash_decode"] == attention_layers(cfg) * 8,
          f"families parity {arch}: {launches['flash_decode']} decode-kernel "
          "launches")
    np.testing.assert_allclose(card["step_logits"].numpy(),
                               cpu["step_logits"].numpy(), rtol=1e-4, atol=1e-4)
    check(torch.equal(card["tokens"], cpu["tokens"]),
          f"families parity {arch}: greedy tokens differ between card and CPU")
    line = {
        "model": f"serve {arch} reduced", "steps": 8,
        "max_abs_logit_diff": float(
            (card["step_logits"] - cpu["step_logits"]).abs().max()),
        "tokens_equal": True, "launches": launches["flash_decode"],
    }
    if cfg.use_mla:
        absorbed = {}
        for name, model in (("card", card_model), ("cpu", cpu_model)):
            model.cfg = replace(cfg, opt_mla_absorb=True)
            reset_launches()
            absorbed[name] = serve.generate(
                model, prompts.to(next(model.parameters()).device), 9)
            check(read_launches()["flash_decode"] == 0,
                  f"families parity {arch} absorbed: a decode-kernel launch")
            model.cfg = cfg
        np.testing.assert_allclose(absorbed["card"]["step_logits"].numpy(),
                                   absorbed["cpu"]["step_logits"].numpy(),
                                   rtol=1e-4, atol=1e-4)
        check(torch.equal(absorbed["card"]["tokens"], absorbed["cpu"]["tokens"]),
              f"families parity {arch} absorbed: greedy tokens differ")
        line["absorb_max_abs_logit_diff"] = float(
            (absorbed["card"]["step_logits"] - absorbed["cpu"]["step_logits"])
            .abs().max())
        line["absorb_vs_expanded_max_abs_logit_diff"] = float(
            (absorbed["card"]["step_logits"] - card["step_logits"]).abs().max())
    emit("card_vs_cpu", line)


def families_phase(dev, total):
    """Phase 20: the five other transformer families on the serve path at
    full width, bf16 weights seeded on the card, B = 8, a 1024-row prompt
    (LLaVA: 576 patch rows and 448 tokens), 16 new tokens (15 decode
    steps); one model at a time, each freed before the next. For each: (a)
    two runs give bitwise equal tokens and step logits; (b) finite logits;
    (c) the decode kernel launched (attention layers) x 15 times in the
    second run, counted from 0 just before it (0 for Mamba2); (d) prefill
    ms, the decode median ms a step (CUDA events), tokens/s, the peak over
    the phase's baseline, the weights' and the decode caches' bytes, and
    ``family_decode_profile``; (e) ``family_parity``.
    DeepSeek-V2-Lite also decodes with ``opt_mla_absorb``: no decode-kernel
    launch, its decode median and the largest logit difference from the
    expanded path (printed, not held). The runs' launches are added to
    ``total``."""
    import statistics
    from dataclasses import replace

    import torch

    from repro_torch import serve
    from repro_torch.launch.shapes import attention_layers
    from repro_torch.models.transformer.model import init_caches, init_params

    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    emit("families_start", {"resident_bytes": baseline})
    t_phase = time.perf_counter()
    B, steps = FAMILY_BATCH, FAMILY_NEW - 1
    for arch, layers, text in FAMILY_RUNS:
        t_model = time.perf_counter()
        cfg = serve.serve_config(arch, reduced=False, layers=layers)
        model = init_params(cfg, torch.Generator(dev).manual_seed(0))
        weights = sum(p.numel() * p.element_size() for p in model.parameters())
        prompts = torch.as_tensor(serve.make_prompts(cfg, B, text, 0), device=dev)
        patches = serve.make_patches(cfg, B, 0)
        if patches is not None:
            patches = torch.as_tensor(patches, device=dev).to(model.embed.dtype)
        first, _ = counted_generate(model, prompts, patches)
        torch.cuda.reset_peak_memory_stats()
        out, launches = counted_generate(model, prompts, patches)
        peak = torch.cuda.max_memory_allocated() - baseline
        check(torch.equal(first["tokens"], out["tokens"])
              and torch.equal(first["step_logits"], out["step_logits"]),
              f"families {arch}: two serve runs differ")
        check(bool(torch.isfinite(out["step_logits"]).all()),
              f"families {arch}: non-finite logits")
        want = attention_layers(cfg) * steps
        check(launches["flash_decode"] == want,
              f"families {arch}: {launches['flash_decode']} decode-kernel "
              f"launches, expected {attention_layers(cfg)} layers x {steps} steps")
        for k, v in launches.items():
            total[k] += v
        caches = init_caches(cfg, B, cfg.num_patches + text + FAMILY_NEW, "meta")
        line = {
            "arch": arch, "family": cfg.family, "layers": cfg.num_layers,
            "reduced": FAMILY_CUTS.get(arch), "dtype": cfg.dtype, "batch": B,
            "prompt_rows": cfg.num_patches + text, "new_tokens": FAMILY_NEW,
            "bitwise_equal": True,
            "prefill_ms": out["prefill_ms"],
            "decode_ms_per_step": statistics.median(out["step_ms"]),
            "step_ms": out["step_ms"], "decode_ms": out["decode_ms"],
            "tokens_per_s": B * steps / (out["decode_ms"] / 1e3),
            "weights_bytes": weights, "peak_over_phase_baseline": peak,
            "cache_bytes": sum(t.numel() * t.element_size() for c in caches
                               for t in _leaves(c)),
            "launches": launches["flash_decode"],
            "tokens_0": out["tokens"][0].reshape(-1)[:16].tolist(),
        }
        if arch == "deepseek-v2-lite-16b":
            model.cfg = replace(cfg, opt_mla_absorb=True)
            absorbed, a_launches = counted_generate(model, prompts, patches)
            model.cfg = cfg
            check(a_launches["flash_decode"] == 0,
                  f"families {arch} absorbed: {a_launches['flash_decode']} "
                  "decode-kernel launches")
            diff = (absorbed["step_logits"] - out["step_logits"]).abs()
            line["absorb"] = {
                "decode_ms_per_step": statistics.median(absorbed["step_ms"]),
                "max_abs_logit_diff": float(diff.max()),
                "max_abs_logit_diff_by_step": diff.flatten(1).amax(1).tolist(),
                "tokens_equal": bool(torch.equal(absorbed["tokens"],
                                                 out["tokens"])),
            }
        line["profile"] = family_decode_profile(model, prompts,
                                                cfg.num_patches + text)
        del model, prompts, patches, first, out
        gc.collect()
        torch.cuda.empty_cache()
        family_parity(dev, arch)
        line["model_s"] = time.perf_counter() - t_model
        emit("family", line)
    emit("families", {"wall_s": time.perf_counter() - t_phase,
                      "resident_bytes": baseline, "card": CARD})


#: phase 21's models: (arch, depth cut or None, batch, text tokens a
#: sequence; a VLM's 576 patch rows come before them), each trained at full
#: width in bf16 over 4096 rows a sequence
TRAIN_RUNS = [
    ("smollm-135m", None, 2, 4096),
    ("deepseek-v2-lite-16b", 6, 2, 4096),
    ("deepseek-v2-236b", 2, 2, 4096),
    ("mamba2-2.7b", None, 2, 4096),
    ("hymba-1.5b", None, 2, 4096),
    ("musicgen-medium", None, 2, 4096),
    ("llava-next-mistral-7b", None, 1, 3520),
]
TRAIN_STEPS, TRAIN_LR = 4, 1e-3
#: a train step holds 8 bytes a parameter in bf16: weights, gradients and
#: the two Adam slots
TRAIN_CUTS = {
    "deepseek-v2-lite-16b": "depth cut from 27 to 6 layers (the dense lead "
                            "layer and 5 MoE layers), widths unchanged: 27 "
                            "layers hold 125.6 GB of bf16 weights, gradients "
                            "and Adam slots",
    "deepseek-v2-236b": FAMILY_CUTS["deepseek-v2-236b"],
}
#: the reduced configs held card vs CPU: (arch, batch, sequence); SmolLM's
#: 2048 rows run ``attention_flash`` and its backward
TRAIN_PARITY = [("smollm-135m", 1, 2048), ("deepseek-v2-lite-16b", 2, 32),
                ("deepseek-v2-236b", 2, 32), ("mamba2-2.7b", 2, 32),
                ("hymba-1.5b", 2, 32), ("musicgen-medium", 2, 32),
                ("llava-next-mistral-7b", 2, 32)]
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
#: a gradient entry at most this share of its leaf's largest is roundoff:
#: its sign may differ between devices, and Adam's normalised step then
#: moves the weight by lr either way
ROUNDOFF = 1e-5


def train_batch(cfg, batch, text, dev):
    """Phase 21's seeded batch on ``dev``: the serve path's prompt draw
    (``make_prompts``) as tokens, a VLM's ``make_patches`` rows in the
    model's dtype."""
    import torch

    from repro_torch import serve

    tokens = torch.as_tensor(serve.make_prompts(cfg, batch, text, 0), device=dev)
    patches = serve.make_patches(cfg, batch, 0)
    if patches is not None:
        patches = torch.as_tensor(patches, device=dev).to(getattr(torch, cfg.dtype))
    return tokens, patches


def train_run(cfg, dev, tokens, patches):
    """A model seeded on ``dev`` and ``TRAIN_STEPS`` steps of
    ``make_train_step`` + ``adamw(1e-3)`` on one batch: (the model, losses
    and aux on the host, each step's ms by the host clock ending in a
    sync)."""
    import torch

    from repro_torch.models.transformer.model import init_params, make_train_step
    from repro_torch.train.optimizer import adamw

    model = init_params(cfg, torch.Generator(dev).manual_seed(0))
    opt = adamw(TRAIN_LR)
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt)
    losses, auxes, ms = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(model, state, tokens, patches)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["loss"])
        auxes.append(metrics["aux"])
    return model, torch.stack(losses).cpu(), torch.stack(auxes).cpu(), ms


def remat_check(dev):
    """Phase 21 (b): SmolLM-135M at full width, B = 1, S = 2048, one seeded
    model: ``lm_loss`` and its gradients with ``opt_remat="full"`` and
    ``"none"``, bit for bit, and each one's peak over what was allocated
    before it."""
    from dataclasses import replace

    import torch

    from repro_torch import serve
    from repro_torch.models.transformer.model import init_params, lm_loss

    cfg = serve.serve_config("smollm-135m", reduced=False)
    model = init_params(cfg, torch.Generator(dev).manual_seed(0))
    tokens, _ = train_batch(cfg, 1, 2048, dev)
    out, peaks = {}, {}
    for remat in ("full", "none"):
        model.cfg = replace(cfg, opt_remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        total, _ = lm_loss(model, tokens)
        grads = torch.autograd.grad(total, list(model.parameters()))
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        out[remat] = (total.detach(), grads)
        del total, grads
    check(torch.equal(out["full"][0], out["none"][0])
          and all(torch.equal(a, b) for a, b in zip(out["full"][1],
                                                    out["none"][1])),
          "lm-train remat: full and none differ")
    emit("lm_train_remat", {"arch": cfg.name, "batch": 1, "seq": 2048,
                            "bitwise_equal": True,
                            "loss": float(out["full"][0]),
                            "peak_full": peaks["full"],
                            "peak_none": peaks["none"]})


def train_parity(dev, arch, batch, seq):
    """Phase 21 (c): ``arch``'s reduced config (2 layers, f32), one seeded
    model built on the CPU and copied to the card, the same batch: the loss,
    aux and every gradient of ``lm_loss``, and the weights after one train
    step, within rtol/atol 1e-4. A weight whose CPU gradient is roundoff
    (at most ``ROUNDOFF`` of its leaf's largest entry) may take Adam's step
    of lr the other way on the card: such weights are held within 2 x lr
    and counted. No kernel launches."""
    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.models.transformer.model import (
        init_params,
        lm_loss,
        make_train_step,
    )
    from repro_torch.train.optimizer import adamw

    cfg = serve.serve_config(arch, reduced=True)
    models = {"cpu": init_params(cfg, torch.Generator().manual_seed(0))}
    models["card"] = copy.deepcopy(models["cpu"]).to(dev)
    res = {}
    reset_launches()
    for where, model in models.items():
        device = dev if where == "card" else torch.device("cpu")
        tokens, patches = train_batch(cfg, batch, seq, device)
        params = list(model.parameters())
        total, metrics = lm_loss(model, tokens, patches)
        grads = [g.cpu() for g in torch.autograd.grad(total, params)]
        opt = adamw(TRAIN_LR)
        make_train_step(cfg, opt)(model, opt.init(params), tokens, patches)
        res[where] = (float(metrics["loss"].detach()),
                      float(metrics["aux"].detach()), grads,
                      [p.detach().cpu() for p in params])
    launches = read_launches()
    check(not any(launches.values()), f"lm-train parity {arch}: {launches}")
    cpu, card = res["cpu"], res["card"]
    np.testing.assert_allclose(card[:2], cpu[:2], **TRAIN_TOL)
    names = [n for n, _ in models["cpu"].named_parameters()]
    flipped = 0
    for n, g_cpu, g_card, w_cpu, w_card in zip(names, cpu[2], card[2], cpu[3],
                                               card[3]):
        np.testing.assert_allclose(g_card.numpy(), g_cpu.numpy(), **TRAIN_TOL,
                                   err_msg=f"{arch} gradient {n}")
        close = torch.isclose(w_card, w_cpu, **TRAIN_TOL)
        roundoff = g_cpu.abs() <= ROUNDOFF * g_cpu.abs().max()
        check(bool((close | roundoff).all()),
              f"lm-train parity {arch}: {n} off where the gradient is not "
              "roundoff")
        check(bool(((w_card - w_cpu).abs()[~close] <= 2.02 * TRAIN_LR).all()),
              f"lm-train parity {arch}: {n} off by more than 2 lr")
        flipped += int((~close).sum())
    emit("card_vs_cpu", {
        "model": f"train {arch} reduced", "batch": batch, "seq": seq,
        "loss_diff": abs(card[0] - cpu[0]),
        "max_abs_grad_diff": max(float((a - b).abs().max())
                                 for a, b in zip(card[2], cpu[2])),
        "max_abs_weight_diff": max(float((a - b).abs().max())
                                   for a, b in zip(card[3], cpu[3])),
        "roundoff_weights_apart": flipped,
        "weights": sum(w.numel() for w in cpu[3]),
    })


def lm_train_phase(dev, total):
    """Phase 21: the transformer train step at full width, bf16 weights
    seeded on the card, ``adamw(1e-3)``, one seeded batch, one config at a
    time, each freed before the next (``TRAIN_RUNS``; the DeepSeek configs
    cut in depth, ``TRAIN_CUTS``). (a) For each: two runs of 4 steps from
    one seed give bitwise equal losses, aux and final weights; the losses
    are finite and step 4's is below step 1's; no CUDA kernel of the port
    launched; one line with the median step ms over steps 2-4 of the second
    run (host clock ending in a sync), tokens/s, ``model_flops`` (6 x
    active parameters x tokens, the reference's train count), ``mfu``
    against the card's dense bf16 peak, the peak over the phase's baseline
    and the depth cut (``python -m repro_torch.profile_train`` profiles a
    step of any of them). (b) ``remat_check``. (c) ``train_parity`` for each
    family's reduced config. The runs' launches (none) are added to
    ``total``."""
    import statistics

    import torch

    from repro_torch import serve
    from repro_torch.launch.shapes import roofline_record

    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    emit("lm_train_start", {"resident_bytes": baseline})
    t_phase = time.perf_counter()
    for arch, layers, batch, text in TRAIN_RUNS:
        t_model = time.perf_counter()
        cfg = serve.serve_config(arch, reduced=False, layers=layers)
        tokens, patches = train_batch(cfg, batch, text, dev)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        model, losses, auxes, first_ms = train_run(cfg, dev, tokens, patches)
        n_params = sum(p.numel() for p in model.parameters())
        weights = [p.detach().cpu() for p in model.parameters()]
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model, losses2, auxes2, ms = train_run(cfg, dev, tokens, patches)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() - baseline
        check(torch.equal(losses, losses2) and torch.equal(auxes, auxes2),
              f"lm-train {arch}: two runs' losses differ {losses} {losses2}")
        check(all(torch.equal(p.detach().cpu(), w)
                  for p, w in zip(model.parameters(), weights, strict=True)),
              f"lm-train {arch}: two runs' final weights differ")
        check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0],
              f"lm-train {arch}: losses {losses.tolist()}")
        check(not any(launches.values()),
              f"lm-train {arch}: kernel launches {launches}")
        for k, v in launches.items():
            total[k] += v
        rows = cfg.num_patches + text
        step_s = statistics.median(ms[1:]) / 1e3
        # the roofline of train_4k at this batch: flops counted on the meta
        # device (no second run), the least bytes from shapes
        rec = roofline_record(cfg, model, "train_4k", batch, rows, step_s)
        terms, share = rec["roofline"], rec["roofline_share"]
        model_flops = terms["model_flops"]
        check(share <= SHARE_LIMIT,
              f"lm-train {arch}: roofline share {share} above {SHARE_LIMIT}")
        emit("lm_train", {
            "arch": arch, "family": cfg.family, "layers": cfg.num_layers,
            "reduced": TRAIN_CUTS.get(arch), "dtype": cfg.dtype,
            "batch": batch, "rows": rows, "params": n_params,
            "active_params": cfg.active_param_count(),
            "bitwise_equal": True, "losses": losses.tolist(),
            "aux": auxes.tolist(), "step_ms": ms, "first_run_step_ms": first_ms,
            "step_ms_median": step_s * 1e3,
            "tokens_per_s": batch * rows / step_s,
            "model_flops": model_flops, "mfu": rec["mfu"],
            "flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
            "roofline": terms, "roofline_share": share,
            "peak_over_phase_baseline": peak,
            "launches": sum(launches.values()),
            "model_s": time.perf_counter() - t_model,
        })
        del model, weights, tokens, patches
        gc.collect()
        torch.cuda.empty_cache()
    remat_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    for arch, batch, seq in TRAIN_PARITY:
        train_parity(dev, arch, batch, seq)
    emit("lm_train_phase", {"wall_s": time.perf_counter() - t_phase,
                            "resident_bytes": baseline, "card": CARD})


#: phase 22's shapes beside phase 21's train_4k, each run through
#: ``launch/shapes.py::run_one`` for every config
SHAPE_RUNS = ("prefill_32k", "decode_32k", "long_500k")
#: every shape's depth cuts (widths unchanged): DeepSeek-V2-236B's 60 layers
#: are 439 GiB of bf16 weights; 2 (the dense lead layer and one MoE layer)
#: fit the card
SHAPE_LAYERS = {"deepseek-v2-236b": 2}
#: prefill_32k's depth cuts (widths unchanged): the plain flash loop visits
#: 528 live (1, H, 1024, 1024) float32 blocks a layer at 32768 rows, 0.16-0.7
#: s a layer by heads (0.24 s at SmolLM's 9 heads, host-bound; NVIDIA H100
#: 80GB HBM3 at 700 W), and
#: a prefill runs twice (a warm call, a timed one): the
#: attention configs run 8 layers (Granite's 52 would take 36 s a call),
#: Hymba (a 1024-row window), Mamba2 and 236B's 2 layers run whole
SHAPE_PREFILL_LAYERS = {**SHAPE_LAYERS, **{arch: 8 for arch in (
    "smollm-135m", "gemma-7b", "granite-20b", "phi3-mini-3.8b",
    "musicgen-medium", "deepseek-v2-lite-16b", "llava-next-mistral-7b")}}
#: a roofline share above this means the count is wrong: the step ran faster
#: than the card's least time for it
SHARE_LIMIT = 1.05
#: bytes of float32 copies a layer-0 check's plain version may hold at a
#: time (at least one sequence's)
CHECK_BYTES = 2e9


def layer0_check(dev, arch, shape, gen):
    """A ``run_one`` ``after`` hook: the decode kernel held against
    ``ref.decode_attention_bound`` on layer 0 of the run's cache, at its
    full valid length, with a seeded q: the whole batch in one launch, as
    the step launches it (MLA's whole latent cache expanded to per-head keys
    and values, ``mla_kv_expand``, as the step expands it: ``card_batch``
    holds room for it), the plain version a few sequences at a time. Its
    launches, read as the counter's rise (``layer0_launches``), compare and
    do not serve: the phase takes them out of the run's counts."""
    import torch

    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref
    from repro_torch.models.transformer.blocks import mla_kv_expand

    out = {}

    @torch.inference_mode()
    def after(model, cfg, specs):
        cache = specs["caches"][0]
        if cfg.family == "ssm":
            return
        if cfg.family == "hybrid":
            cache = cache["attn"]
        H = cfg.num_heads
        if cfg.use_mla:
            D, Dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
            k, v = mla_kv_expand(model.layers()[0].attn, cfg, cache["c_kv"],
                                 cache["k_rope"])
        else:
            k, v = cache["k"], cache["v"]
            D = Dv = cfg.head_dim
        B, S, KV = k.shape[:3]
        q = torch.randn(B, H, D, device=dev, generator=gen).to(k.dtype)
        n = torch.tensor([S], dtype=torch.int32, device=dev)
        n0 = fd.LAUNCHES["flash_decode"]
        got = fd.flash_decode(q, k, v, n)
        launched = fd.LAUNCHES["flash_decode"] - n0
        # float32 K, V repeated to H heads, and |V|, a sequence
        per_seq = 4 * S * H * (D + 2 * Dv)
        step = max(1, int(CHECK_BYTES // per_seq))
        err = rel = 0.0
        for i in range(0, B, step):
            want, tol = ref.decode_attention_bound(
                q[i:i + step], k[i:i + step], v[i:i + step], n.reshape(()))
            diff = (got[i:i + step].float() - want).abs()
            check(bool((diff <= tol).all()),
                  f"shapes {arch} {shape}: the decode kernel at layer 0 is "
                  f"{float(diff.max())} off, outside its bound")
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / tol).max()))
        out.update(layer0_launches=launched, layer0_sequences=B, layer0_rows=S,
                   layer0_chunk=fd.decode_chunk(B, KV, S, H // KV),
                   layer0_max_abs_err=err, layer0_max_err_over_bound=rel)

    return after, out


def shapes_phase(dev, total):
    """Phase 22: the reference's input shapes on the card. For each of the
    ten configs, ``run_one`` of ``prefill_32k`` (B = 1, the depth cut of
    ``SHAPE_PREFILL_LAYERS``), ``decode_32k`` (one card's batch,
    ``card_batch``) and ``long_500k`` (B = 1; full attention windowed at
    8192 rows, the ring 64 windows past its first row), DeepSeek-V2-236B at
    2 layers, each freed before the next, one line a record. Checks: finite
    logits; the decode kernel launched (attention layers) x 7 steps in a
    decode run and never in a prefill (counted from 0 just before each
    run, less the layer-0 check's launches, and as ``run_one``'s own
    count); the kernel at layer 0 of each decode cache within its bound
    (``layer0_check``); every roofline share at most ``SHARE_LIMIT``. The
    runs' launches are added to ``total``."""
    import torch

    from repro_torch.configs import list_archs
    from repro_torch.launch.shapes import DECODE_TIMED, DECODE_WARM, run_one

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(22)
    n = 0
    for arch in list_archs():
        for shape in SHAPE_RUNS:
            t_run = time.perf_counter()
            decode = shape != "prefill_32k"
            after, checked = layer0_check(dev, arch, shape, gen) if decode \
                else (None, {})
            torch.cuda.synchronize()
            reset_launches()
            rec = run_one(arch, shape, dev, after=after,
                          layers=(SHAPE_LAYERS if decode
                                  else SHAPE_PREFILL_LAYERS).get(arch))
            launches = read_launches()
            launches["flash_decode"] -= checked.get("layer0_launches", 0)
            for k, v in launches.items():
                total[k] += v
            want = rec["attention_layers"] * (DECODE_WARM + DECODE_TIMED) \
                if decode else 0
            check(launches["flash_decode"] == want == rec["launches"],
                  f"shapes {arch} {shape}: {launches['flash_decode']} "
                  f"decode-kernel launches, expected {want}")
            check(not any(v for k, v in launches.items() if k != "flash_decode"),
                  f"shapes {arch} {shape}: launches {launches}")
            check(rec["logits_finite"], f"shapes {arch} {shape}: non-finite logits")
            check(rec["roofline_share"] <= SHARE_LIMIT,
                  f"shapes {arch} {shape}: roofline share "
                  f"{rec['roofline_share']} above {SHARE_LIMIT}")
            check(not decode or rec["attention_layers"] == 0
                  or "layer0_max_abs_err" in checked,
                  f"shapes {arch} {shape}: layer 0 not checked")
            gc.collect()
            torch.cuda.empty_cache()
            emit("shape", {**rec, **checked, "card": CARD,
                           "run_s": time.perf_counter() - t_run})
            n += 1
    emit("shapes", {"records": n, "wall_s": time.perf_counter() - t_phase,
                    "card": CARD})


def entry_points_phase(dev, total):
    """Phase 23: ``repro_torch.train_gnn_e2e.main`` on the card at its
    defaults (orkut-s, SAGE, P = 4, split beside dp, the partitioned cache)
    for 40 steps, on the serial plan source and once with
    ``--plan-source pipelined``, each checkpointing into a temporary
    directory, with the counts at 0 just before and read just after: its
    two asserts hold (the last 20 losses below the first 20, dp loading
    more rows), and the forward, the row adjoint and the shuffle adjoint
    launched. The launches are added to ``total``."""
    import torch

    from repro_torch import train_gnn_e2e

    for source in ("serial", "pipelined"):
        t_run = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt:
            torch.cuda.synchronize()
            reset_launches()
            out = train_gnn_e2e.main(["--steps", "40", "--plan-source", source,
                                      "--ckpt-dir", ckpt])
            torch.cuda.synchronize()
            launches = read_launches()
        for k, v in launches.items():
            total[k] += v
        for k in ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "shuffle_bwd"):
            check(launches[k] > 0, f"train_gnn_e2e {source}: {k} never launched")
        check(out["steps"] == 40 and "first20" in out and "dedup_ratio" in out,
              f"train_gnn_e2e {source}: {out['steps']} steps")
        emit("train_gnn_e2e", {
            "plan_source": source, "device": out["device"],
            "steps": out["steps"], "first20": out["first20"],
            "last20": out["last20"], "dedup_ratio": out["dedup_ratio"],
            "split_loaded": out["split_loaded"], "dp_loaded": out["dp_loaded"],
            "loop_s": out["seconds"], "launches": launches,
            "wall_s": time.perf_counter() - t_run, "card": CARD})


#: phase 24: the configs, their depth cut, the batch, the prompt rows and the
#: new tokens (8 decode steps)
TP_ARCHS = ("granite-20b", "deepseek-v2-lite-16b")
TP_LAYERS, TP_BATCH, TP_PROMPT, TP_NEW = 2, 8, 1024, 9
#: the sharded float32 serve run against the unsharded one on the card
TP_TOL = dict(rtol=1e-4, atol=1e-4)
#: the allocator's rounding (512 bytes an allocation) and the generator's
#: state, beside a rank's slices and one leaf while it builds its weights
TP_BUILD_SLACK = 1 << 20


def tp_phase(dev, total):
    """Phase 24: the transformer across ranks on the serve path
    (``serve.generate`` with a mesh, ``serve.serve_rank``), Granite-20B (MQA:
    its k/v cache sharded by sequence) and DeepSeek-V2-Lite-16B (MLA: its
    latents sharded by sequence; its experts sharded) at full width cut to
    ``TP_LAYERS`` layers, weights seeded on the card, 8 prompts of 1024 rows
    and 8 decode steps. (a) The unsharded float32 serve run, its decode
    kernel launched once an attention layer and step. (b) The (1, 1) mesh
    over NCCL at world size 1 (a process group of this process alone):
    tokens and step logits bitwise (a). (c) The (1, 2) mesh, two ranks
    sharing ``cuda:0`` over gloo (``launch(shared_card=True)``; gloo takes
    no CUDA tensor for an all-gather, so every collective copies through
    the host, and the line says so), float32: each rank's logits within
    ``TP_TOL`` of (a) with equal tokens, each rank's parameters half of each
    sharded leaf, the decode kernel's partial output launched once an
    attention layer and step on each rank and its whole output never, each
    rank's collectives by axis and kind (calls and result bytes) and peak
    memory, and each rank's peak while it builds its weights within its
    slices and one whole leaf (``TP_BUILD_SLACK`` beside); then bf16, its
    tokens and decode ms a step (CUDA events, ranks sharing one card and
    copying through the host: no measure of a mesh's speed); then f32 once
    more with ``serve_rank(profile_peak=True)``: the allocations alive at
    each rank's peak over ``generate`` (a profile run, its logits checked,
    its times not kept). Launch counts are set to 0 just before each serve
    run and read just after, the ranks' in their own processes; all are
    added to ``total``."""
    import tempfile
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch import serve
    from repro_torch.configs import get_arch
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.launch.shapes import attention_layers
    from repro_torch.launch.sharding import cache_slice, param_slice
    from repro_torch.models.transformer.model import (
        empty_params,
        init_caches,
        init_params,
    )

    t_phase = time.perf_counter()
    cfgs = {arch: replace(get_arch(arch), num_layers=TP_LAYERS, dtype="float32")
            for arch in TP_ARCHS}
    steps = TP_NEW - 1
    # (a) unsharded
    want = {}
    for arch, cfg in cfgs.items():
        model = init_params(cfg, torch.Generator(dev).manual_seed(0))
        prompts = torch.as_tensor(serve.make_prompts(cfg, TP_BATCH, TP_PROMPT, 0),
                                  device=dev)
        torch.cuda.synchronize()
        reset_launches()
        want[arch] = serve.generate(model, prompts, TP_NEW)
        launches = read_launches()
        for k in total:
            total[k] += launches[k]
        check(launches["flash_decode"] == attention_layers(cfg) * steps,
              f"tp {arch}: {launches['flash_decode']} decode-kernel launches "
              "unsharded")
        del model, prompts
    torch.cuda.empty_cache()
    # (b) the (1, 1) mesh over NCCL, in this process
    with tempfile.TemporaryDirectory(prefix="tp-") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "rdv"), 1), rank=0, world_size=1, device_id=dev)
        try:
            for arch, cfg in cfgs.items():
                reset_launches()
                out = serve.serve_rank(dev, cfg, (1, 1), TP_NEW,
                                       batch=TP_BATCH, prompt_len=TP_PROMPT)
                launches = read_launches()
                for k in total:
                    total[k] += launches[k]
                check(torch.equal(out["step_logits"], want[arch]["step_logits"])
                      and torch.equal(out["tokens"], want[arch]["tokens"]),
                      f"tp {arch}: the (1, 1) mesh is not bitwise the "
                      "unsharded serve run")
                emit("tp", {"model": arch, "mesh": [1, 1], "backend": "nccl",
                            "bitwise_unsharded": True,
                            "launches": launches["flash_decode"],
                            "collectives": out["collectives"]["count"]})
        finally:
            dist.destroy_process_group()
    # (c) two ranks sharing the card; then f32 again with the allocator's
    # history on (a profile run: its times are not kept)
    runs = [(dtype, arch, False) for dtype in ("float32", "bfloat16")
            for arch in cfgs] + [("float32", arch, True) for arch in cfgs]
    tasks = [(functools.partial(serve.serve_rank, profile_peak=profile),
              (replace(cfgs[arch], dtype=dtype), (1, 2), TP_NEW, TP_BATCH,
               TP_PROMPT))
             for dtype, arch, profile in runs]
    t0 = time.perf_counter()
    ranks = spmd.launch(tasks, world=2, shared_card=True, timeout_s=600.0)
    t_launch = time.perf_counter() - t0
    for i, (dtype, arch, profile) in enumerate(runs):
        cfg = replace(cfgs[arch], dtype=dtype)
        outs = [r[i] for r in ranks]
        meta = empty_params(cfg, "meta")
        largest = max(p.numel() * p.element_size() for p in meta.parameters())
        # the context of the prompt and the new tokens, rounded up to the two
        # ranks
        ctx = -(-(TP_PROMPT + TP_NEW) // 2) * 2
        meta_caches = init_caches(cfg, TP_BATCH, ctx, "meta")
        for rank, out in enumerate(outs):
            # the rank holds its spec's slice of every parameter and cache
            on = abstract_mesh((1, 2), coords={"model": rank})
            check({k: tuple(v.shape) for k, v in param_slice(cfg, meta, on).items()}
                  == out["param_shapes"],
                  f"tp {arch} {dtype} rank {rank}: parameter slices")
            check([serve._shapes(c) for c in cache_slice(cfg, meta_caches, on)]
                  == out["cache_shapes"],
                  f"tp {arch} {dtype} rank {rank}: cache slices")
            launches = out["launches"]
            total["flash_decode"] += launches["flash_decode"]
            total["flash_decode_partial"] += launches["flash_decode_partial"]
            check(launches["flash_decode_partial"] == attention_layers(cfg) * steps
                  and launches["flash_decode"] == 0,
                  f"tp {arch} {dtype} rank {rank}: launches {launches}")
            check(out["host_transport"], f"tp {arch}: gloo on a card without "
                  "host transport")
            # a rank builds one leaf at a time: its slices and one leaf
            check(out["build_peak_bytes"] <= out["param_bytes"] + largest
                  + TP_BUILD_SLACK,
                  f"tp {arch} {dtype} rank {rank}: building took "
                  f"{out['build_peak_bytes']} bytes, above its "
                  f"{out['param_bytes']} bytes of slices and a leaf of "
                  f"{largest}")
        check(torch.equal(outs[0]["tokens"], outs[1]["tokens"]),
              f"tp {arch} {dtype}: the two model ranks' tokens differ")
        if profile:
            for out in outs:
                torch.testing.assert_close(out["step_logits"],
                                           want[arch]["step_logits"], **TP_TOL)
            emit("tp_peak", {
                "model": arch, "dtype": dtype, "mesh": [1, 2],
                "what": "the allocations alive at a rank's peak over "
                        "generate (obs/memory.py::peak_profile)",
                "peak_bytes_per_rank": [o["peak_profile"]["allocated_before"]
                                        + o["peak_profile"]["peak_bytes"]
                                        for o in outs],
                "max_memory_allocated": [o["max_memory_allocated"]
                                         for o in outs],
                "allocated_before": [o["peak_profile"]["allocated_before"]
                                     for o in outs],
                "top_rank0": outs[0]["peak_profile"]["top"]})
            continue
        line = {"model": arch, "dtype": dtype, "mesh": [1, 2],
                "backend": "gloo, both ranks on cuda:0",
                "transport": "every collective copies through the host",
                "layers": TP_LAYERS, "batch": TP_BATCH, "prompt": TP_PROMPT,
                "steps": steps,
                "launches_per_rank": [o["launches"] for o in outs],
                "collectives_per_rank": [o["collectives"]["by_axis"]
                                         for o in outs],
                "peak_bytes_per_rank": [o.get("max_memory_allocated") for o in outs],
                "build_peak_bytes_per_rank": [o["build_peak_bytes"] for o in outs],
                "param_bytes_per_rank": [o["param_bytes"] for o in outs],
                "largest_leaf_bytes": largest,
                "prefill_ms": [o["prefill_ms"] for o in outs],
                "decode_ms_per_step": [statistics.median(o["step_ms"])
                                       for o in outs]}
        if dtype == "float32":
            ref = want[arch]
            for out in outs:
                torch.testing.assert_close(out["step_logits"],
                                           ref["step_logits"], **TP_TOL)
                check(torch.equal(out["tokens"], ref["tokens"]),
                      f"tp {arch}: the sharded tokens differ from the "
                      "unsharded run's")
            line["max_abs_logit_diff"] = max(
                float((o["step_logits"] - ref["step_logits"]).abs().max())
                for o in outs)
            line["tokens_equal_unsharded"] = True
            line["unsharded_decode_ms_per_step"] = statistics.median(
                ref["step_ms"])
        else:
            line["tokens"] = outs[0]["tokens"][0].reshape(-1).tolist()
        line["cache_shapes_layer0"] = outs[0]["cache_shapes"][0]
        line["params_and_caches_are_the_specs_slices"] = True
        emit("tp", line)
    emit("tp_phase", {"wall_s": time.perf_counter() - t_phase,
                      "launch_s": t_launch})


#: phase 25: the configs, their depth cut, the batch, the rows, the steps
TPT_ARCHS = ("granite-20b", "deepseek-v2-lite-16b", "mamba2-2.7b",
             "hymba-1.5b")
TPT_LAYERS, TPT_BATCH, TPT_SEQ, TPT_STEPS = 2, 2, 1024, 2
#: ``launch/shapes.py::TRAIN_LR``, the rate ``train_rank`` trains at
TPT_LR = 1e-3
#: the sharded float32 step against the unsharded one on the card: the
#: first step's loss (relative: both runs from the same weights), a later
#: step's within ``TPT_LATER_RTOL`` (after an Adam step whose noise-sensitive
#: entries, below, differ; a MoE's routing may then flip a near tie, as in
#: ``tests/test_torch_lm_train_step.py``'s free-running losses); the first
#: step's gradient over its leaf's max abs (the repo's gradient tolerance
#: between two float32 reduction orders, ``tests/test_torch_lm_train.py``:
#: at full width cuBLAS sums the sharded products' shapes in other orders,
#: and an embedding row adds its tokens' rows in another); a
#: weight after the steps within ``launch/shapes.py::REF_TOL`` (1e-4) of
#: its leaf's max abs, but for Adam's
#: noise-sensitive entries: where a gradient is small against the float32
#: noise of its sums, the two runs' normalised steps m / sqrt(v) differ by
#: up to a whole lr, either way (within 2 lr x 1.01 a step;
#: ``tests/test_torch_lm_train_step.py``); their count is reported
TPT_LOSS_RTOL, TPT_LATER_RTOL = 1e-5, 1e-4
TPT_GRAD_TOL = 1e-4
TPT_FLIP = 2 * TPT_LR * 1.01
#: (c): the served configs, the batch, the prompt rows, the new tokens
TPT_SERVE = ("mamba2-2.7b", "hymba-1.5b")
TPT_SERVE_BATCH, TPT_SERVE_PROMPT, TPT_SERVE_NEW = 2, 1024, 9


def tp_train_reference(dev, cfg, path=None, with_grads=False):
    """The unsharded train step of ``cfg`` on the card (weights from a
    generator on the card seeded 0, ``train_rank``'s batch): its losses,
    the seconds it took, and ``train_rank``'s ``reference``: its weights
    after the steps with each leaf's max abs (and, with ``with_grads``,
    AdamW's m after the first step, (1 - b1) times the first gradient, and
    its max abs), on the card, or with
    ``path`` saved there for the ranks (the run freed before they
    start)."""
    import torch

    from repro_torch.launch.shapes import train_batch
    from repro_torch.models.transformer.model import (
        init_params,
        make_train_step,
    )
    from repro_torch.train.optimizer import adamw

    model = init_params(cfg, torch.Generator(dev).manual_seed(0))
    data = train_batch(cfg, TPT_BATCH, TPT_SEQ, 0)
    tokens = torch.as_tensor(data["tokens"], device=dev)
    names = [n for n, _ in model.named_parameters()]
    saved = {}
    opt = adamw(TPT_LR)
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for k in range(TPT_STEPS):
        state, metrics = step(model, state, tokens)
        losses.append({n: float(v) for n, v in metrics.items()})
        if k == 0 and with_grads:  # AdamW's first m: (1 - b1) g
            saved["first_m"] = {n: m.to("cpu", copy=True) for n, m in zip(
                names, state.slots["m"])}
            saved["first_m_scale"] = {n: float(m.float().abs().max())
                                      for n, m in zip(names, state.slots["m"])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    named = {n: p.detach() for n, p in model.named_parameters()}
    ref = {"params": named, "scale": {n: float(t.float().abs().max())
                                      for n, t in named.items()}, **saved}
    if path is None:
        return losses, wall, ref
    ref["params"] = {n: t.cpu() for n, t in named.items()}
    try:  # the zip records' checksums halve the write's speed
        from torch.utils.serialization import config
        crc, config.save.compute_crc32 = config.save.compute_crc32, False
    except ImportError:
        config = None
    try:
        torch.save(ref, path)
    finally:
        if config is not None:
            config.save.compute_crc32 = crc
    del model, state, named, step, saved, ref
    torch.cuda.empty_cache()
    return losses, wall, path


def tp_weights_check(name, out, losses, exact):
    """A rank's losses and weights against the unsharded run's: bitwise
    (``exact``), or within the tolerances (``TPT_*``); returns the line's
    numbers."""
    err = out["param_err"]
    if exact:
        check(out["losses"] == losses and all(e == 0.0 for e in err.values()),
              f"tp-train {name}: the (1, 1) mesh is not bitwise the "
              f"unsharded train step: losses {out['losses']} vs {losses}, "
              f"weights off {[n for n, e in err.items() if e]}")
        return {"entries": out["param_count"]}
    for i, (got, want) in enumerate(zip(out["losses"], losses, strict=True)):
        rtol = TPT_LATER_RTOL if i else TPT_LOSS_RTOL
        for k in ("loss", "aux"):
            check(abs(got[k] - want[k]) <= rtol * abs(want[k]),
                  f"tp-train {name}: step {i + 1} {k} {got[k]} vs {want[k]}")
    grad_err = out["grad_err"]
    check(all(e <= TPT_GRAD_TOL for e in grad_err.values()),
          f"tp-train {name}: first-step gradients off "
          f"{ {n: e for n, e in grad_err.items() if e > TPT_GRAD_TOL} }")
    check(all(d <= TPT_FLIP * TPT_STEPS for d in out["param_off_max"].values()),
          f"tp-train {name}: weights off by more than {TPT_STEPS} Adam "
          f"steps: {out['param_off_max']}")
    off = {n: c for n, c in out["param_off"].items() if c}
    return {"max_param_err_over_maxabs": max(err.values()),
            "worst_leaf": max(err, key=err.get),
            "max_grad_err_over_maxabs": max(grad_err.values()),
            "entries_beyond_tol": sum(off.values()),
            "entries_beyond_tol_by_leaf": off,
            "their_max_grad_over_leaf_max": max(
                [out["param_off_grad"][n] for n in off], default=0.0),
            "their_max_abs_err": max(out["param_off_max"].values()),
            "entries": out["param_count"],
            "loss_rel_err": [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                                 for k in ("loss", "aux"))
                             for g, w in zip(out["losses"], losses)]}


def tp_train_phase(dev, total):
    """Phase 25: the transformer train step across ranks
    (``make_train_step(cfg, adamw, mesh)`` through
    ``launch/shapes.py::train_rank``) and Mamba2 and Hymba on a model axis,
    at full width cut to ``TPT_LAYERS`` layers (the header's (a)-(c)). The
    unsharded runs go first, one config at a time, each freed before the
    next run but for its weights after the steps: on the card for the
    (1, 1) run beside it in (a), in a file the ranks read their slices of
    in (b). Launch counts are set to 0 just before each run and read just
    after (the ranks' in their own processes); all are added to
    ``total``; the train step launches none."""
    import tempfile
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch import serve
    from repro_torch.configs import get_arch
    from repro_torch.launch import spmd
    from repro_torch.launch.shapes import TRAIN_LR, attention_layers, train_rank
    from repro_torch.models.transformer.model import init_params

    check(TPT_LR == TRAIN_LR, f"tp-train: the ranks train at {TRAIN_LR}")
    t_phase = time.perf_counter()
    base = {arch: replace(get_arch(arch), num_layers=TPT_LAYERS)
            for arch in TPT_ARCHS}
    refs, t_parts = {}, {}
    with tempfile.TemporaryDirectory(prefix="tp-train-") as tmp:
        # (a) bf16: the unsharded step, then the (1, 1) mesh over NCCL in
        # this process, against the unsharded weights on the card
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "rdv"), 1), rank=0, world_size=1, device_id=dev)
        try:
            for arch, cfg in base.items():
                cfg = replace(cfg, dtype="bfloat16")
                reset_launches()
                refs[arch] = tp_train_reference(dev, cfg)
                check(sum(read_launches().values()) == 0,
                      f"tp-train {arch}: the train step launched a kernel")
                out = train_rank(dev, cfg, (1, 1), TPT_STEPS, TPT_BATCH,
                                 TPT_SEQ, reference=refs[arch][2],
                                 record=False)
                refs[arch] = refs[arch][:2]
                torch.cuda.empty_cache()
                line = tp_weights_check(f"{arch} (1, 1)", out, refs[arch][0],
                                        exact=True)
                check(out["collectives"][0]["count"] == 0,
                      f"tp-train {arch}: collectives at (1, 1)")
                emit("tp_train", {"model": arch, "dtype": "bfloat16",
                                  "mesh": [1, 1], "backend": "nccl",
                                  "bitwise_unsharded": True,
                                  "losses": out["losses"],
                                  "step_ms": out["step_ms"],
                                  "unsharded_wall_s": refs[arch][1],
                                  "peak_bytes": out.get("peak_bytes"),
                                  "entries": line["entries"]})
        finally:
            dist.destroy_process_group()
        t_parts["a_s"] = time.perf_counter() - t_phase
        # (b) f32: the unsharded step of each config; (c) the unsharded
        # serve runs
        f32 = {arch: replace(cfg, dtype="float32") for arch, cfg in base.items()}
        for arch, cfg in f32.items():
            refs[arch] = tp_train_reference(dev, cfg, os.path.join(
                tmp, f"{arch}-f32.pt"), with_grads=True)
        t_parts["f32_references_s"] = (time.perf_counter() - t_phase
                                       - t_parts["a_s"])
        want = {}
        for arch in TPT_SERVE:
            cfg = f32[arch]
            model = init_params(cfg, torch.Generator(dev).manual_seed(0))
            prompts = torch.as_tensor(serve.make_prompts(
                cfg, TPT_SERVE_BATCH, TPT_SERVE_PROMPT, 0), device=dev)
            reset_launches()
            want[arch] = serve.generate(model, prompts, TPT_SERVE_NEW)
            launches = read_launches()
            for k in total:
                total[k] += launches[k]
            check(launches["flash_decode"] == attention_layers(cfg)
                  * (TPT_SERVE_NEW - 1),
                  f"tp-train {arch}: {launches} unsharded")
            del model, prompts
        torch.cuda.empty_cache()
        tasks = [(functools.partial(train_rank, reference=refs[arch][2],
                                    record=False),
                  (cfg, (1, 2), TPT_STEPS, TPT_BATCH, TPT_SEQ))
                 for arch, cfg in f32.items()]
        tasks += [(serve.serve_rank, (f32[arch], (1, 2), TPT_SERVE_NEW,
                                      TPT_SERVE_BATCH, TPT_SERVE_PROMPT))
                  for arch in TPT_SERVE]
        t0 = time.perf_counter()
        ranks = spmd.launch(tasks, world=2, shared_card=True, timeout_s=600.0)
        t_launch = time.perf_counter() - t0
    for i, arch in enumerate(TPT_ARCHS):
        outs = [r[i] for r in ranks]
        lines = [tp_weights_check(f"{arch} rank {rank}", out, refs[arch][0],
                                  exact=False)
                 for rank, out in enumerate(outs)]
        check(outs[0]["digests"] == outs[1]["digests"] and outs[0]["digests"],
              f"tp-train {arch}: the replicated leaves differ across ranks")
        for out in outs:
            check(out["collectives"][0] == out["collectives"][1],
                  f"tp-train {arch}: the two steps' collectives differ")
        check(outs[0]["collectives"] == outs[1]["collectives"],
              f"tp-train {arch}: the two ranks' collectives differ")
        by = outs[0]["collectives"][0]["by_axis"]
        emit("tp_train", {
            "model": arch, "dtype": "float32", "mesh": [1, 2],
            "backend": "gloo, both ranks on cuda:0",
            "transport": "every collective copies through the host",
            "layers": TPT_LAYERS, "batch": TPT_BATCH, "seq": TPT_SEQ,
            "steps": TPT_STEPS, "losses": outs[0]["losses"],
            "unsharded_losses": refs[arch][0],
            "loss_rel_err_by_step": [max(e) for e in zip(
                *(ln["loss_rel_err"] for ln in lines))],
            "max_grad_err_over_maxabs": [ln["max_grad_err_over_maxabs"]
                                         for ln in lines],
            "max_param_err_over_maxabs": [ln["max_param_err_over_maxabs"]
                                          for ln in lines],
            "worst_leaf": [ln["worst_leaf"] for ln in lines],
            "entries_beyond_1e-4": [ln["entries_beyond_tol"] for ln in lines],
            "entries_per_rank": [ln["entries"] for ln in lines],
            "beyond_by_leaf_rank0": lines[0]["entries_beyond_tol_by_leaf"],
            "their_max_grad_over_leaf_max": [
                ln["their_max_grad_over_leaf_max"] for ln in lines],
            "their_max_abs_err": [ln["their_max_abs_err"] for ln in lines],
            "replicated_leaves_bitwise": len(outs[0]["digests"]),
            "collectives_per_step": by,
            "collective_bytes_per_step": outs[0]["collectives"][0]["total"],
            "peak_bytes_per_rank": [o.get("peak_bytes") for o in outs],
            "step_ms_per_rank": [o["step_ms"] for o in outs],
            "unsharded_wall_s": refs[arch][1], "card": CARD})
    for j, arch in enumerate(TPT_SERVE):
        outs = [r[len(TPT_ARCHS) + j] for r in ranks]
        cfg = f32[arch]
        steps = TPT_SERVE_NEW - 1
        for rank, out in enumerate(outs):
            torch.testing.assert_close(out["step_logits"],
                                       want[arch]["step_logits"],
                                       rtol=1e-4, atol=1e-4)
            check(torch.equal(out["tokens"], want[arch]["tokens"]),
                  f"tp-train {arch} rank {rank}: tokens differ")
            state = out["cache_shapes"][0]["state"]
            check(state[1] == cfg.ssm_nheads // 2,
                  f"tp-train {arch}: state {state} not sharded by head")
            launches = out["launches"]
            total["flash_decode"] += launches["flash_decode"]
            total["flash_decode_partial"] += launches["flash_decode_partial"]
            check(launches["flash_decode"] == 0 and
                  launches["flash_decode_partial"]
                  == attention_layers(cfg) * steps,
                  f"tp-train {arch} rank {rank}: launches {launches}")
        emit("tp_train_serve", {
            "model": arch, "dtype": "float32", "mesh": [1, 2],
            "batch": TPT_SERVE_BATCH, "prompt": TPT_SERVE_PROMPT,
            "steps": steps, "tokens_equal_unsharded": True,
            "max_abs_logit_diff": max(
                float((o["step_logits"] - want[arch]["step_logits"]).abs()
                      .max()) for o in outs),
            "cache_shapes_layer0": outs[0]["cache_shapes"][0],
            "launches_per_rank": [o["launches"] for o in outs],
            "collectives_per_rank": [o["collectives"]["by_axis"] for o in outs],
            "decode_ms_per_step": [statistics.median(o["step_ms"])
                                   for o in outs],
            "card": CARD})
    emit("tp_train_phase", {"wall_s": time.perf_counter() - t_phase,
                            "launch_s": t_launch, **t_parts})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_smoke = time.perf_counter()
    import numpy as np

    from dataclasses import replace

    from repro_torch.graph.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    global CARD
    CARD = smi
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # ---- 2. build: one nvcc per source, all together ----------------------
    t0 = time.perf_counter()
    build.load_libraries(LIBRARIES)
    emit("build", {
        "wall_s": time.perf_counter() - t0,
        "seconds": {n: build.build_seconds[n] for n in LIBRARIES},
        "ptxas": {n: [line.strip() for line in build.build_log.get(n, "").splitlines()
                      if "Compiling entry function" in line or "Used" in line
                      or "spill" in line]
                  for n in LIBRARIES},
    })

    # ---- 3. kernels -----------------------------------------------------
    first = papers_first_batch()
    results = {}
    kernel_phase(dev, first, results)
    wavefront_phase(dev, first, results)
    shuffle_phase(dev, first, results)
    dst, mask, N = packed_phase(dev, first, results)
    flash_decode_phase(dev, results)
    flash_decode_partial_check(dev)
    total = dict.fromkeys(read_launches(), 0)
    for k, v in packed_entry_points(dev, dst, mask, N).items():
        total[k] += v

    # ---- 4. main path at full width ------------------------------------
    papers = first.ds
    # a pipelined source that hangs fails the run instead of stalling it
    cfg = TrainConfig(num_devices=4, fanouts=FANOUTS, batch_size=1024,
                      presample_epochs=2, stall_timeout_s=120.0)
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "src_sorted_csr",
            "shuffle_bwd")
    main_losses, main_iters = {}, {}
    for source in ("serial", "pipelined"):
        launches, tr, stats, main_losses[source] = run_trainer(
            papers, GNNSpec(model="sage"), replace(cfg, plan_source=source),
            dev, 3, f"sage, {source} source", both, epochs=3)
        main_iters[source] = [it for e in stats for it in e.iters]
        if source == "serial":  # phase 18 ends in this state
            main_final = [t.detach().cpu() for t in tr._opt_tensors()]
        del tr
        for k in total:
            total[k] += launches[k]
    check(main_losses["serial"] == main_losses["pipelined"],
          f"main: serial and pipelined losses differ {main_losses}")
    emit("pipeline_parity", {"sources": ["serial", "pipelined"],
                             "bitwise_equal": True,
                             "steps": len(main_losses["serial"])})

    # ---- 4b. staging from pinned memory ----------------------------------
    staging_phase()

    # ---- 5. the other models -------------------------------------------
    for model, expect, epochs in (
            ("gcn", both, 1), ("gat", both + ("gather_segsum_bwd_w",), 2)):
        launches, _, _, model_losses = run_trainer(
            papers, GNNSpec(model=model, num_heads=4), cfg, dev, 2, model,
            expect, epochs=epochs)
        for k in total:
            total[k] += launches[k]
    gat_losses = model_losses

    # ---- 6. card vs CPU on a small graph --------------------------------
    tiny = make_dataset("tiny")
    tcfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=16,
                       presample_epochs=2, lr=5e-3)
    # split; split with replication (10% of the tiny graph's rows); dp
    for variant, vcfg, models in (
        ("split", tcfg, ("sage", "gcn", "gat")),
        ("replication", replace(tcfg, replication_budget=0.1), ("sage", "gat")),
        ("dp", replace(tcfg, mode="dp"), ("sage", "gcn", "gat")),
    ):
        for model in models:
            spec = GNNSpec(model=model, in_dim=tiny.spec.feat_dim, hidden_dim=64,
                           out_dim=tiny.spec.num_classes, num_layers=2)
            model0 = GNN(spec, generator=torch.Generator().manual_seed(0))
            losses = {}
            for where in ("cpu", dev):
                tr = Trainer(tiny, spec, vcfg, device=where,
                             model=copy.deepcopy(model0))
                check((tr.rep_block is not None) == (variant == "replication"),
                      f"parity {variant}: replication block")
                losses[str(where)] = [it.loss for it in
                                      tr.train_epoch(max_iters=3).iters]
            np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)
            emit("card_vs_cpu", {"model": model, "variant": variant,
                                 "cuda": losses[str(dev)], "cpu": losses["cpu"]})

    # ---- 7. the device plan sources -------------------------------------
    launches, device_pipelined_losses = device_source_phase(papers, cfg, dev)
    for k, v in launches.items():
        total[k] += v

    # ---- 8. run-to-run determinism --------------------------------------
    determinism_phase(papers, cfg, dev, dst, mask, N)
    model, prompts = serve_model(dev)
    serve_determinism(model, prompts)

    # ---- 9. the serve path at full width --------------------------------
    for k, v in serve_phase(model, prompts).items():
        total[k] += v
    del model, prompts

    # ---- 10. serve, card vs CPU on a reduced model ----------------------
    serve_parity_phase(dev)

    # ---- 11. faults on the pipelined device source -----------------------
    faults_phase(papers, cfg, dev, device_pipelined_losses)

    # ---- 12. tracing ------------------------------------------------------
    tracing_phase(papers, cfg, dev, main_losses["pipelined"])

    # ---- 13. the overlap schedule -----------------------------------------
    overlap_phase(dev, first, cfg, main_losses["serial"], total)

    # ---- 14. the feature cache --------------------------------------------
    cache_phase(first, cfg, dev, main_losses["serial"], device_pipelined_losses,
                total)

    # ---- 15. hot-vertex replication and telemetry -------------------------
    replication_phase(dev, first, cfg, main_losses["serial"],
                      main_iters["serial"], device_pipelined_losses, total)

    # ---- 16. dp and pushpull ----------------------------------------------
    dp_losses = dp_phase(first, cfg, dev, main_iters["serial"], total)

    # ---- 17. the 2-D (replica, split) mesh ---------------------------------
    mesh_r2 = mesh_phase(first, cfg, dev, main_losses["serial"],
                         main_iters["serial"], dp_losses, total)

    # ---- 18. checkpoint and resume -----------------------------------------
    checkpoint_phase(first, cfg, dev, {
        "serial": main_losses["serial"], "pipelined": main_losses["serial"],
        "device": device_pipelined_losses,
        "device_pipelined": device_pipelined_losses,
    }, main_final, mesh_r2, gat_losses, total)

    # ---- 19. the spmd path over torch.distributed ---------------------------
    spmd_phase(first, cfg, dev, total)

    # ---- 20. the other transformer families on the serve path --------------
    del first, papers
    families_phase(dev, total)

    # ---- 21. the transformer train step ----------------------------------
    lm_train_phase(dev, total)

    # ---- 22. the reference's input shapes ---------------------------------
    shapes_phase(dev, total)

    # ---- 23. the entry points ----------------------------------------------
    entry_points_phase(dev, total)

    # ---- 24. the transformer across ranks ---------------------------------
    tp_phase(dev, total)

    # ---- 25. the train step across ranks, Mamba2 and Hymba on a model axis -
    tp_train_phase(dev, total)

    emit("smoke", {"wall_s": time.perf_counter() - t_smoke, "card": CARD})
    for k, r in results.items():
        r["launches"] = total[k]
    # the partial-output calls of phase 24's sharded decode launch the same
    # kernels (its partial and merge kernels) on the path
    results["flash_decode"]["launches"] += total["flash_decode_partial"]
    results["flash_decode"]["partial_launches"] = total["flash_decode_partial"]
    # the walk's builds (three kernels each) on the main paths
    results["gather_segsum_bwd_mixed"]["csr_builds"] = total["src_sorted_csr"]
    check(sorted(results) == sorted(KERNELS), f"kernels held: {sorted(results)}")
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
