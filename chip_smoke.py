#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vipant_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py ckpt_phase      # some phases, by name (PHASES), in their order

1. Prints the card's name and power limit (nvidia-smi); fails without CUDA.
2. Builds the CUDA kernels from ``vipant_tpu_torch/csrc`` and prints the
   build time and the compiler's register / spill report.
3. Kernel phase: each forward kernel and each fused sub-block, at the
   serving path's shapes and at the audio tower's batch of 64, against its
   plain PyTorch version on the card from the same seeded bf16 inputs, with
   CUDA-event times of both; ``layernorm_fwd`` alone at every (rows, C) the
   paths give it (``LAYERNORM_CASES``: the towers at batch 4, 16 and 64, the
   packed text and image rows, the captioning decoder and its KV-cached
   decode at T = 1, the AT step's audio tower at B50 and text tower at B50
   and B250), with its device µs per call beside ``F.layer_norm``'s
   (a profiler window; the loops of the small shapes are bound by the host);
   ``gemm_bias_act`` alone at every product shape
   the paths give it (``GEMM_FWD_CASES``: the towers at batch 4 and 64, the
   MLP's proj + residual, the recomputed fc with its fp32 pre-activation, the
   VA step's image tower, the captioning decoder's four products at
   M = 64 x 77 and its KV-cached decode at T = 1, M = 4, 16, 64, 256, the AT
   step's audio tower at M = 50 x 306 and text tower at 50 and 250 x 77), each
   held bitwise equal over two runs; ``patch_gather`` at the towers' inputs
   (``PATCH_CASES``: the VA step's audio and image at B432, the embed
   request's audio at B64, the AT step's at B50, DeiT's stride-10 audio grid),
   bitwise its plain version and over two runs, beside the library path it
   replaced (the input rounded to bf16, then ``F.unfold``) and the one PyTorch call that
   gives the same bits in one launch (a rounding copy of the input's unfold
   view, ``unfold_copy_ms``); ``attention_fwd``'s streaming
   form (T > 704) at B16 T705 and T971 beside SDPA.
4. Backward kernel phase: each backward kernel, and each sub-block's
   backward through its autograd boundary (``torch.autograd.grad`` from fp32
   params, as the training step takes it), against its plain version, from
   seeded bf16 inputs and a seeded cotangent: attention at the audio tower's
   B4 T306 C768 H12 (no bias), the text tower's B1 T308 C512 H8 (causal +
   packing) and the training step's B64 T306 C768 H12 (M = 19,584 rows),
   MLP at the same three shapes (E3072, E2048, E3072) for QuickGELU and
   exact GELU; ``gemm_wgrad`` also at the captioning decoder's four
   products (M = 64 x 77 rows, width 512) and the AT step's audio tower's
   (M = 50 x 306 = 15,300, no multiple of 128), each weight grad named with its
   row split (S chunks, blocks launched) and held bitwise equal over two
   runs; ``colsum`` alone at every bias grad of the trained towers
   (``COLSUM_CASES``: dbout and dbproj, dbqkv in fp32, dbfc, at audio batch
   64, 4 and 50 and the decoder's M = 64 x 77), named with its row split, held
   bitwise equal over two runs and to ``colsum_ordered`` (the plain sum in
   the kernel's order), with device µs per call beside ``torch.sum``'s;
   ``layernorm_bwd`` alone at every (rows, C) the training paths give it
   (``LAYERNORM_BWD_CASES``: the audio tower at batch 64, 4, 16 and 50, the
   caption decoder at B64 and B16 T77, the packed text rows), named with its
   grid plan, dw and db held bitwise equal over two runs and db bitwise to
   ``layernorm_bwd_ordered`` (the plain sums in the kernel's order), with
   device µs per call beside autograd through ``F.layer_norm``;
   ``gemm_dgrad`` alone at every product shape the training paths
   give it (``GEMM_DGRAD_CASES``: the audio tower at batch 4, 64 and 50 and the
   caption decoder's M = 64 x 77, with each activation grad), each held
   bitwise equal over two runs; ``attention_bwd`` also at the decoder's B64 T77 (causal) and at
   B16 T200 with the packing bias, bitwise equal over two runs, and its
   recomputed p held bitwise to the forward's (v one-hot on a window of
   keys gives p out of the forward, do one-hot on a window of queries out
   of the backward's dv).
5. Serving slice: the full-size CLAP serving engine (ViT-B/32 audio tower at
   T = 306, 12-layer width-512 text tower packed 4 captions per call at
   T = 308) with seeded random weights: embed_audio over 6 fbanks at batch
   4, embed_texts, zero_shot over 3 classes. Checks finite unit-norm
   outputs, the launch counts of every sub-block, and cosine >= 0.999
   against the same engine on the plain ops on the card.
6. Training slice: the flagship VA pre-training step (``bench.py``'s
   overrides: frozen ViT-B/32 image tower packed 4 per call at T = 200,
   trainable audio tower at T = 306, CELossHead, LARS at production knobs
   with ``steps_per_epoch=1000``) with seeded random weights:
   (i) at B = 16, loss, grad_norm and every trainable grad from the kernels
   against the plain ops on the card, both in bf16, and against the plain
   ops in fp32 from the same init. Per grad, the kernels may be no further
   from the fp32 grads than the plain bf16 grads are: cosine at most 5e-3
   lower, relative error |K - F| / |F| at most 3e-2 higher, and the scale
   along the fp32 grad, s(V) = V.F / |F|^2, within |s(K) - s(P)| <= 5e-2
   (a mis-scaled grad, which cosine cannot see; unlike the norm, s is not
   raised by noise orthogonal to F). The loss head's ``logit_scale`` is left
   out of these two:
   its grad is one scalar, a sum over B^2 near-cancelling logits taken
   from the forward's features before any backward kernel runs. bf16 rounding alone puts the two bf16 paths 1-2 % apart on
   the smallest bias grads, so their mutual cosine is printed but not held
   to 0.999; (ii) the launch
   counts of one step: 12 backward launches of each sub-block, all from the
   audio tower; (iii) five LARS steps: finite losses, audio params moved by
   step 2, image params bitwise unchanged; (iv) at B = 64, ms per step,
   forward / forward+backward / optimizer split and clips/s for kernels and
   plain ops, and a ``torch.profiler`` trace: device idle share and the top
   kernels by device time; (v) an Adam descent smoke (lr 1e-3, 4 fixed
   batches of 32, 60 steps) whose first 10 losses agree with the plain ops.

7. Int8 kernel phase: ``layernorm_rowquant`` at every case of
   ``LAYERNORM_CASES``, bitwise ``rowquant(layernorm_fwd(x))`` and across two
   runs; ``rowquant`` at every case of ``ROWQUANT_CASES`` (the four weights
   of each tower width, the fp32 context and act(a) of every int8 tower and
   batch), codes and scales bitwise its plain version and across two runs,
   both with device µs per call; ``rowquant`` on the chain's own inputs,
   the fp32-context attention and both int8 sub-blocks against their plain
   versions from seeded inputs (one all-zero token), at audio B4 and B64
   T306 C768 H12, text B1 and B16 T308 C512 H8 (causal + packing), image
   B16 T200 C768 H12 (block-diagonal); QuickGELU and exact GELU; with the
   time of the bf16 kernel chain of the same sub-block; ``gemm_i8`` alone at
   every product shape of those towers (``GEMM_I8_CASES``, each epilogue),
   bitwise equal over two runs, its integer sum at unit scales bitwise the
   exact one.
8. Int8 serving: the full CLAP engine with ``quantize="int8"`` from the
   bf16 engine's seed: finite unit-norm embeddings; every sub-block call of
   both towers on the int8 chain and none on the bf16 one; cosine >= 0.999
   against the same engine on the plain int8 ops; cosine against the bf16
   kernel engine >= 0.99 per tower, or at least no further from it than the
   plain int8 path is (both printed); zero-shot predictions beside the bf16
   engine's; ms per batch of 4 and of 64, int8 beside bf16.
9. Training with ``model.image.int8_frozen=True``: at B = 16 the image
   features against the bf16 frozen tower, loss and grad_norm beside the
   bf16 step's; the launch counts of one step (the image tower on the int8
   chain only, the audio tower's forward and backward unchanged); five LARS
   steps with the image params bitwise unchanged; at B = 64 ms per step
   beside the bf16 step's; the Adam descent smoke under ``int8_frozen``.

10. Flash kernel phase: ``flash_attention_fwd``, ``_bwd`` and ``_dbias``
   against their plain versions at ``FLASH_CASES``: the captioning decoder's
   cross-attention (B64 and B4, Tq 77 against Tk 61; the re-forward decode's
   Tq 32), equal lengths (B16 T971 H12 without bias, T77 causal, B16 T200
   H12 with the block-diagonal packing bias and its grad), with q, k, v read
   as contiguous tensors, as sections of a packed [B, T, 3C] tensor and as
   transposed [B, H, T, D] views (outputs bitwise equal across the three),
   the forward, dq, dk, dv and the bias grad bitwise equal across two runs,
   the bias grad on small-integer inputs (exact products) bitwise
   ``kernels.flash_attention_dbias_ordered``, a query row masked everywhere
   uniform; ``F.scaled_dot_product_attention``, its autograd backward and
   that backward for a float mask timed beside them, each also in device µs
   per call beside the kernels'.
11. Probe phase: ``dot_variant`` at every ``DOT_CASES`` case (the probe's
   256 x 128 x 384, multiples of 16 but not of 64, and K = 1024) in its four
   orientations, one seeded logical product stored four ways, against the
   fp32 product (max |d| <= 1e-3), with its device µs per call beside
   ``torch.matmul``'s (its loop is bound by the host), the four orientations
   and two runs bitwise equal, zeros at K = 0, its launch (``vt_dot_plan``)
   equal to ``kernels.dot_plan``; ``probe_fused_fwd`` at B64 T306 C768
   against its plain version and against ``fused_attention_block``; then the
   probe path (the port's probe entry and the public ``flash_attention`` op
   with a trainable bias), whose launches are counted.
12. Captioning training: CLAP with the ``SeqGenerationHead`` decoder (width
   512, 12 layers, 8 heads, ctx 77, vocabulary 49,408) cross-attending into
   the trainable ViT-B/32 audio tower's 61 x 5 feature grid, ``LMLossHead``,
   LARS: (a) at B = 16 loss and every grad from the kernels against the plain
   ops and against fp32, by the criterion of phase 6 (i); (b) the launch
   counts of one step (12 forward and 12 backward flash launches, no bias
   grad, 24 + 24 fused calls of each sub-block); (c) at B = 64 ms per step
   with the forward / forward+backward / optimizer split, the plain ops'
   time, peak memory and the profiler's top kernels; (d) an Adam smoke on one
   fixed batch: the LM loss falls below 0.9x its start in 60 steps.
13. Captioning serving: ``InferenceEngine.caption`` at batch 4 and 64, greedy
   and ``beam=4``: ms per batch and per decode step at batch 64 (one timed
   call each; the batch-4 timings and the profiler windows left out to keep
   the script's time); the launch counts of the
   path; KV-cached greedy against the re-forward decoder (per-step logits
   within 0.1 up to a row's first differing token, which must fall where the
   re-forward's top-2 margin is below that; the share of equal ids is
   printed); ``beam=1`` gives the greedy ids; teacher-forced logits on the
   kernels against the plain ops (cosine >= 0.999 per row); the same engine
   with ``quantize="int8"`` decodes on the int8 sub-blocks.
14. VA epoch loop (full width): a seeded synthetic index written to a temp
   dir (``write_synthetic_va``: 256 train and 64 eval clips of 10 s 16 kHz
   wav, a 256 x 256 JPEG frame each, or none when PIL is missing; an npz
   twin of the train split with 1000 x 128 fbanks); ``Trainer.learn`` at the
   flagship config, B = 64, two epochs of 4 steps, ``loader_backend=process``
   with ``min(8, cpu_count)`` workers, SpecAugment on: (a) run A, 8 steps with
   a save and an eval at 6 (``save_rate=6``), its launches counted (path
   ``va_loop``), then a save at 8;
   (c) finite losses, the audio tower moved by step 2; (d) the retrieval
   report of the 64 eval clips, finite; (e) ``InferenceEngine`` on A's step 8
   (``model.npz``, the image tower from ``state.pt``): ``embed_audio`` of
   those clips at cosine >= 0.999 to the trainer's eval features; (b) run B,
   a fresh trainer resumed from A's step 6, bitwise A at step 8 (every
   trainable param and LARS buffer); (g) the pinned copy against its races:
   loader batches put with each side-stream copy held back, read on the
   compute stream at once after ``wait`` and again after the batch's
   tensors were dropped and the next copy ran, bytewise their host batches;
   a put without ``wait_event`` and one without ``record_stream`` must each
   be caught; (f) ms per step of the loop, clips/s and the share of the
   window spent waiting for the loader, timed from an epoch's first batch's
   arrival to its last's (3 steps of the wav train split, 5 of the npz
   split read 3 times), beside the step alone on a loader batch and phase
   6's step at B = 64, with the card's name and power limit; and a
   ``torch.profiler`` window of 3 steady npz steps (``profile.alive``): the
   card's idle share and each host thread's time inside torch ops.
15. AT fine-tuning (``LAMonitor``, full width): ``LA_FULL`` (``CLAP_FULL``
   with ``monitor=LAMonitor``: the trainable ViT-B/32 audio tower at T = 306,
   the frozen 12-layer width-512 text tower at ctx 77, ``CELossHead``) at
   ``running/clotho.yaml``'s batch of 50: (a) one step's loss and every
   audio-tower grad from the kernels against the plain ops and against fp32
   by phase 6 (i)'s criterion; the launches of one step (12 + 12 sub-block
   calls forward, 12 backward, none from the text tower); ms per step with
   the forward / forward+backward / optimizer split and peak memory. On a
   seeded synthetic Clotho index written to a temp dir
   (``write_synthetic_clotho``: 200 train, 50 eval and 50 test clips of 20 s
   16 kHz wav, 5 distinct captions each), ``build_monitor(...).learn()`` for
   2 epochs of 4 steps with ``loader_backend=process`` and ``min(8,
   cpu_count)`` workers: (b) run A at the default CE bound, ``save_rate=6``:
   the save-time eval at step 6 skipped and logged exactly when that step's
   loss is >= 5, a ``TEST`` report at the end; run B with
   ``running.eval_loss_bound=inf`` and ``save_epoch``: saves and evals at 4,
   6 and 8, each 1-vs-5 report on the 50 eval clips finite, its launches
   counted (path ``la_loop``); (f) ``encode_text`` writes one npz per eval
   clip, each at cosine >= 0.999 to the plain ops' embeddings of the same
   captions; (c) ``model_file=train_0.out`` with ``eval=True``: one report per
   step directory run B's log names, step 8's string for string the one run B
   logged; (d) a fresh ``LATrainer`` resumed from run B's step 6 ends bitwise
   where run B ends (params, optimizer buffers; the caption picks' per-item
   seeds); (e) the captioning variant (``CAPTION_FULL`` with
   ``monitor=LAMonitor``) takes 2 steps of ``learn()``, then
   ``caption_report`` of the 50 eval clips (greedy, 32 decode steps): every
   score finite; (g) the loop's steady window: one epoch of the train split
   read 3 times (12 steps), timed from the arrival of the first batch made
   after the loader's first ``prefetch + 1`` to the last: ms per step,
   clips/s and data-wait share beside (a)'s step alone, with the card's
   name and power limit; (h) the pinned copy's race check of phase 14 (g) on
   host batches from (g)'s workers (fp32 fbanks and int32 token ids).
16. The device frontend and serving from files (full width): (a) the port's
   fbank (``ops/fbank.py``) on a B64 batch of 10.05 s clips against the NumPy
   Kaldi fbank, the rFFT route within 2e-3 and the DFT route within 5e-3
   (the JAX tests' bounds), under this process's TF32 setting (off), with
   device µs of each; (b) SpecAugment on the card bitwise the CPU's for the
   same uniforms; on a synthetic index as phase 14's, (c)
   ``Trainer.learn`` with ``running.audio.on_device``, ``wav_int16`` and
   ``running.image_uint8`` (int16 waveforms and uint8 frames ship; the
   fbank, SpecAugment and the CLIP normalisation run on the card): 2 epochs
   of 4 steps and an eval at step 6, finite losses, the audio tower moved by
   step 2, its launches counted (path ``va_loop_dev``); its steady window
   over the train split read 4 times (ms per step, clips/s, data-wait
   share, the card's idle share in a profiled window, bytes shipped per
   batch) beside phase 14's wav-source window; the audio frontend's own
   device µs; (d) the npz split shipping ``ship_bf16`` and ``ship_int16``
   fbanks through the pinned copy: on the card, bf16 bitwise the fp32 batch
   rounded, int16 within 0.5/256 of it; one training step each; (e)
   ``embed_audio_files``, ``embed_image_files``, ``zero_shot`` from the files'
   fbanks and ``caption_files`` (greedy) at batch 4 on the card, then the
   serving command line (``serve.main``, ``--task embed_audio``) on the same
   files in bf16 (bitwise the engine's) and ``--quantize int8`` (row cosine
   >= 0.99 to bf16), their launches counted (path ``serve_files``); against
   a CPU engine (plain ops, fp32) with the same weights: embeddings and the
   decoder's first-step logits at row cosine >= 0.999, zero-shot scores
   within 0.09 (what 0.999 on both factors allows); (f) ``make_server`` over
   the card's engines: one request per route, each equal to the engine's
   own call; (g) a fresh trainer on the device frontend resumed from (c)'s
   step 6 ends bitwise where (c) ended at step 8 (params, LARS buffers and
   the generator SpecAugment draws from).
17. Checkpoint loading and export (full width): (a) a seeded CLIP ViT-B/32
   state dict (``synthetic_clip_state_dict``: visual width 768, 12 layers,
   50 positions; text width 512, 12 layers, vocabulary 49,408, context 77;
   ~600 MB fp32) written under a name the zoo does not know; (b) the
   ``CLAP_FULL`` engine on the card with ``running.clip_model_root`` /
   ``clip_model_name`` naming it: every text and audio tensor bitwise the
   file's but the audio position grid, re-gridded 7 x 7 -> 61 x 5 within
   1e-5 of a CPU retarget and of one on the card; ``embed_audio`` at batch
   64 and ``embed_texts``, their launches counted (path ``ckpt``), at row
   cosine >= 0.999 to the same engine on the CPU (plain ops, fp32, which
   loads the same file); (c) the flagship VA trainer seeded from the file:
   its frozen image tower bitwise the file's, three steps with finite
   losses, a save with ``export_pth=True`` writing a 2-tuple ``.pth`` whose
   audio tower is the trainer's, and an engine with ``model_file=<that
   .pth>`` at row cosine >= 0.9999 to the trainer's own audio tower in eval
   mode; (d) ``LAMonitor`` with ``model_file=<that .pth>``: its audio tower
   bitwise the file's, one step at B = 50.
18. Classification (full width; ``clf_phase``): (a) the native host fbank
   built from ``vipant_tpu_torch/native/fbank.cc`` on the card's host into
   the phase's directory (its seconds; the library loaded must be that
   build, not one the checkout already held), within 2e-3 of ``fbank_np`` on a 10.05 s clip, ms per clip of
   both routes beside the host's CPU and the card's name and power limit;
   on a seeded ESC-50 tree (``write_synthetic_esc50``: ESC-50's 50 classes,
   5 folds, one 5 s clip a class a fold) and phase 17's CLIP file, (b)
   ``ESCMonitor`` zero-shot (``running.zero_shot``, ``eval=True``): the 50
   prompt embeddings and a B50 batch of audio embeddings at row cosine >=
   0.999 to the plain ops, the pooled P@1 in [0, 100], every host
   featurisation on the native route; (c) the supervised x-fold at B = 50,
   one epoch a fold (5 folds of 4 steps, a fresh model each): fold 1's step
   grads held to fp32 by phase 6 (i)'s criterion, every loss finite, the
   ``summary_report`` mean, the step's ms; (d) ``ASMonitor`` on a seeded
   AudioSet (``write_synthetic_audioset``: 527 labels, 128 train and 64 eval
   clips of 10 s with JPEG frames) with the imagine branch, mixup 0.5 and
   weighted sampling: 4 steps at B = 64 on 8 process workers, the loss and
   its ``bce`` / ``ce`` parts finite, then ``infer`` (the multilabel report)
   and ``zero_shot`` (527 prompts), every number in [0, 100]; (e) the engine
   with ``worker=ESClassifier``: ``zero_shot`` of 6 wav files against 5
   labels at row cosine >= 0.999 (embeddings) and scores within 0.09 of a
   CPU engine (plain ops, fp32); every launch of (b) to (e) counted on the
   path ``clf``.

The packed-shard and trimodal phases follow (``pak_phase``,
``trimodal_phase``: their functions say what they hold), then

21. The other backbones, patchout and asynchronous checkpoints (full width;
   ``backbone_phase``): (a) DeiT (``DEIT_FULL``: both towers DeiT-B/16
   distilled with exact GELU; the audio tower trained at T = 99 x 12 + 2 =
   1,190, the image tower frozen at T = 198): ``attention_fwd`` and
   ``attention_bwd`` in their streaming form and the GELU / GELU' epilogues
   of ``gemm_bias_act`` / ``gemm_dgrad`` at the step's shapes against their
   plain versions (the attention at B = 64 and 16, the plain backward at B =
   64 keeping ≈ 20 GB of [B, 12, 1190, 1190] fp32 tensors); both towers seeded from a synthetic
   full-width timm file through ``meme_path``, every tensor bitwise the CPU
   porter's and, but the re-gridded positions, the heads' seeded init and
   the audio kernel's channel mean, the file's; the step's grads at B = 16
   held to fp32 by phase 6 (i)'s criterion (the audio embeddings' distance
   to fp32 printed for the kernels and the plain ops); at B = 64 the launches of one
   step (path ``deit``), the loss finite and falling over four Adam steps on
   one batch, ms per step; ``embed_audio`` at batch 64 at row cosine >=
   0.999 to the plain ops. (b) RN50 (``RN50_FULL``): both towers seeded from
   a synthetic CLIP RN50 file, every tensor and BatchNorm statistic bitwise
   the file's but the re-gridded pool grid of the audio tower (7 x 7 ->
   31 x 4); a step at B = 64 that launches no hand-written kernel (path
   ``rn50``: ResNet-50 runs none, as the JAX package runs it in XLA), every
   running statistic moving, the frozen image tower's too, and within 1e-3
   of a second run's on the plain ops; the engine at cosine >= 0.999 to the
   plain ops. (c) Patchout (``PATCHOUT_FULL``: 228 of 305 patches kept,
   T = 229): the step's grads at B = 16 held to fp32 by phase 6 (i)'s
   criterion (the three runs draw one subset), a resume from a step-1
   checkpoint bitwise the uninterrupted run over two more steps, the
   launches of one step at B = 64 (path ``patchout``), its ms in turns beside
   the step without patchout and the device busy time of both. (d) Asynchronous checkpoints: the VA loop (phase
   14's config, 128 clips, B = 64, a save at the end of epoch 1) run with
   ``async_ckpt`` and without, each resumed for epoch 2: the resumed runs'
   params, LARS buffers and RNG bitwise equal, the save call's ms printed in
   both modes (path ``async``: the first epoch's launches).
22. The data axis (``dp_phase``; paths ``dp`` and ``grad_cache``). Every
   multi-rank run is a group of subprocesses of this script (``--dp-rank``,
   a ``FileStore`` in a temp dir, all ranks on ``cuda:0``), each printing its
   numbers and launch counts as one JSON line; a rank that exits non-zero or
   outlives its time limit fails the phase. First a probe: whether NCCL takes
   two ranks on one device (it is expected to refuse); the 2-rank runs then
   use gloo on the card (which collectives gloo takes on CUDA tensors is
   probed and printed), and NCCL runs as a group of one. (a) The flagship step at B = 64 on a one-rank
   NCCL group: bitwise the plain training path's step (every param's sha1),
   with the same launch counts. (b) 2 ranks x B = 32: the loss within 1e-3
   relative of the one-rank B = 64 step on the same global batch, the
   averaged grads held to fp32 by phase 6 (i)'s rule against the plain ops
   at B = 64, both ranks' params bitwise equal after 3 steps, the step's ms
   on each rank beside the one-rank step's (both ranks share the card: no
   scaling is measured). (c) ZeRO-1 on those ranks: params after 3 steps
   bitwise the replicated run's, each rank's optimizer-state bytes, a ZeRO
   save after step 1 resumed without ZeRO bitwise the uninterrupted run.
   (d) The VA loop on 2 ranks (phase 14's synthetic index, 64 + 32 clips, B
   = 32, a save and an eval after each of 2 steps): rank 0's report after
   the first save equal to a one-rank eval of that checkpoint, a resume from
   it bitwise the uninterrupted run on both ranks. (e) The gradient cache at
   full width: the VA step at B = 128 in 2 chunks of 64 and the AT step
   (phase 15's config, B = 50) in 2 chunks, their launches (path
   ``grad_cache``) and grads held to fp32 by the same rule against the plain
   step at the same batch; at B = 256 in 4 chunks, ms and peak GiB beside the
   plain step's, the cache's peak the lower. (f) ``InferenceEngine(
   data_parallel=True)`` on one card bitwise the engine without it.
23. The model, pipe and seq axes and model-parallel serving (``mp_phase``;
   paths ``mp_model``, ``mp_pipe``, ``mp_seq``, ``mp_serve``,
   ``mp_serve_int8``). One pair of gloo ranks on ``cuda:0`` (``--dp-rank
   mp``) drives (a)-(d); the parent first runs the one-rank kernel step and
   the one-rank steps and engines they are held to. (a) ``mesh.model=2``:
   the flagship VA step at B = 16 on the plain ops in fp32, every trainable
   grad (the slices gathered) at cosine >= 0.999 to the one-rank fp32 step's
   and its loss within 1e-2 relative; the same step on the kernels, its loss
   and grad norm within 1e-2 relative of the one-rank kernel step's, its
   grads held to the one-rank fp32 grads by phase 6 (i)'s rule with the
   one-rank kernel grads in the plain grads' place (no further from fp32
   than one rank's kernels are: in bf16 a change of summation order alone
   moves small grads by more than 0.999 of cosine, so the per-grad cosine to
   one rank's kernel grads is printed, not gated), each rank's launches
   printed and every kernel of the sub-blocks' chains launched; a save after the step,
   the run's second step, and a resume's second step bitwise equal to it;
   the save loaded into a one-rank trainer, every param bitwise the
   gathered one. (b) ``mesh.pipe=2`` with 4 microbatches and (c)
   ``mesh.seq=2``: the same step and gates (on the ring the attention
   kernels give way to plain products). (d) ``InferenceEngine(
   model_parallel=2)``: ``embed_audio`` and ``embed_texts`` at batch 64,
   bf16 and int8, cosine >= 0.999 to one rank, int8 >= 0.99 to bf16, every
   int8 kernel launched; the captioning engine's greedy decode at batch 4,
   its first step's logits at cosine >= 0.999 to one rank, the captions
   printed beside one rank's. (e) A probe, in a pair of its own, of what gloo
   does with a bf16 all-reduce and a point-to-point exchange of CUDA
   tensors, printed (a crash is its answer). Step and batch ms are printed
   beside the card's name and power limit: readings of two ranks sharing one
   card through host memory, not a scaling number.

Every kernel's time stands beside its bound, the least time the card could
take for the same work: the larger of the bytes it must move (each input
read once, each output written once, taken from the tensors of this run)
over the card's memory rate and its operations over the card's peak rate
for their type (H100 SXM data sheet: 3.35 TB/s; dense 989 TFLOP/s bf16,
1,979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor cores), and beside the
time of the one PyTorch call that computes the same function where there is
one (``library_ms``: ``F.layer_norm``, ``F.linear``, ``torch.matmul``,
``F.scaled_dot_product_attention``, ``torch.sum``, ``torch._int_mm``, and
for ``attention_bwd`` and ``layernorm_bwd`` autograd through
``F.scaled_dot_product_attention`` and ``F.layer_norm``). Those calls are
timed here and used nowhere in the port.

Tolerances: the int8 integer sum bitwise exact; int8 codes equal to the
plain version's except a share of at most 1e-3 off by exactly one (x /
scale within an fp32 ulp of a half), scales to 1e-6 relative; bf16 outputs
at atol = rtol = 2e-2 (one bf16 ulp of the output plus a different fp32
summation order); fp32 outputs (weight, bias and
LayerNorm grads, the fp32 dqkv and pre-activation) at max |d| <= 1e-2 *
max |plain|, since they sum over thousands of rows in another order.

Prints a JSON line of per-kernel results (``launches`` is the sum of the
counts read on each main path (``serve``, ``train``, ``serve_int8``,
``train_int8_frozen``, ``probe``, ``caption_train``, ``caption_serve``, ``va_loop``,
``la_loop``, ``va_loop_dev``, ``serve_files``, ``ckpt``, ``clf``, ``pak``, ``val``, ``vas``,
``barlow``, ``deit``, ``rn50``, ``patchout``, ``async``, ``dp``, ``grad_cache``, ``mp_model``,
``mp_pipe``, ``mp_seq``, ``mp_serve``, ``mp_serve_int8``), which
``launches_by_path`` gives apart; ``ms``,
``plain_ms``, ``bound_ms``, ``bound_by`` and ``library_ms`` are those of the
kernel's first case, its main-path shape; ``cases`` holds each shape's), then, as the last line, ``{"ok": true, "device": {...}}``.
With phase names, the kernels line also names the phases that ran
(``"phases"``), holds only the kernels they reached (``ms`` and the rest
null where no kernel phase ran) and asserts no launch on every kernel.
Any failure raises (non-zero exit)."""

from __future__ import annotations

import contextlib
import itertools
import json
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ATOL = RTOL = 2e-2
REL = 1e-2
COS_MIN = 0.999
COS_SLACK = 5e-3
ERR_SLACK = 3e-2   # per grad: |K - F| / |F| may exceed |P - F| / |F| by this much
SCALE_SLACK = 5e-2  # per grad: |s(K) - s(P)|, s(V) = V.F / |F|^2 the scale along the fp32 grad
BATCH = 4
CLAP_FULL = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
    "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=1000", "worker=CLAP", "model_file=",
]
FLAGSHIP = [  # bench.py's VA pre-training step
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=1000",
    "model.image.token_pack=4", "worker=CVAP", "model_file=",
]
LA_FULL = CLAP_FULL + ["monitor=LAMonitor"]  # AT fine-tuning: running/clotho.yaml's batch of 50
LA_B = 50
CAPTION_FULL = [  # _clap_cfg() with the text tower swapped for the captioning decoder
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_decoder", "+model/loss=ce_lm", "+optimizer=standard",
    "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=1000", "running.retrieval=False", "worker=CLAP", "model_file=",
]
STEPS_PER_EPOCH = 1000
PROMPTS = ["the sound of a dog barking", "heavy rain on a roof", "a car passing by",
           "birds singing in the morning", "people talking in a crowded room"]
CLASSES = {
    "dog": ["the sound of a dog", "a dog barking"],
    "rain": ["the sound of rain", "rain falling"],
    "car": ["the sound of a car"],
}
B2, B4B = "vipant_tpu/ops/fused_attn.py:168", "vipant_tpu/ops/fused_mlp.py:60"
B5, B6 = "vipant_tpu/ops/fused_attn.py:117", "vipant_tpu/ops/fused_mlp.py:97"
B3F, B3B = "vipant_tpu/ops/attention.py:47", "vipant_tpu/ops/attention.py:66"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "layernorm_fwd": ("vipant_tpu_torch/csrc/layernorm.cu", "vipant_tpu/ops/fused_attn.py:81"),
    "gemm_bias_act": ("vipant_tpu_torch/csrc/gemm_fwd.cu", "vipant_tpu/ops/fused_mlp.py:51"),
    "attention_fwd": ("vipant_tpu_torch/csrc/attention.cu", "vipant_tpu/ops/fused_attn.py:81"),
    "fused_ln_attention_block": ("vipant_tpu_torch/ops/fused_attn.py",
                                 "vipant_tpu/ops/fused_attn.py:81"),
    "fused_ln_mlp_block": ("vipant_tpu_torch/ops/fused_mlp.py", "vipant_tpu/ops/fused_mlp.py:51"),
    "layernorm_bwd": ("vipant_tpu_torch/csrc/layernorm.cu", B2),
    "gemm_dgrad": ("vipant_tpu_torch/csrc/gemm_dgrad.cu", B4B),
    "gemm_wgrad": ("vipant_tpu_torch/csrc/gemm_wgrad.cu", B2),
    "colsum": ("vipant_tpu_torch/csrc/reduce.cu", B2),
    "attention_bwd": ("vipant_tpu_torch/csrc/attention_bwd.cu", B2),
    "fused_ln_attention_block_bwd": ("vipant_tpu_torch/ops/fused_attn.py", B2),
    "fused_ln_mlp_block_bwd": ("vipant_tpu_torch/ops/fused_mlp.py", B4B),
    "rowquant": ("vipant_tpu_torch/csrc/quant.cu", B6),
    "layernorm_rowquant": ("vipant_tpu_torch/csrc/quant.cu", B5),
    "gemm_i8": ("vipant_tpu_torch/csrc/gemm_i8.cu", B6),
    "attention_fwd_f32": ("vipant_tpu_torch/csrc/attention.cu", B5),
    "fused_ln_attention_block_int8": ("vipant_tpu_torch/ops/fused_attn.py", B5),
    "fused_ln_mlp_block_int8": ("vipant_tpu_torch/ops/fused_mlp.py", B6),
    "flash_attention_fwd": ("vipant_tpu_torch/csrc/flash_attention.cu", B3F),
    "flash_attention_bwd": ("vipant_tpu_torch/csrc/flash_attention.cu", B3B),
    "flash_attention_dbias": ("vipant_tpu_torch/csrc/flash_attention.cu", B3B),
    "dot_variant": ("vipant_tpu_torch/csrc/dot_variants.cu", "experiments/fused_block_probe.py:46"),
    "probe_fused_fwd": ("vipant_tpu_torch/experiments/fused_block_probe.py",
                        "experiments/fused_block_probe.py:85"),
    "patch_gather": ("vipant_tpu_torch/csrc/patches.cu", "none (XLA: vipant_tpu/ops/patches.py)"),
}
PATHS = ("serve", "train", "serve_int8", "train_int8_frozen", "probe", "caption_train",
         "caption_serve", "va_loop", "la_loop", "va_loop_dev", "serve_files", "ckpt", "clf", "pak", "val",
         "vas", "barlow", "deit", "rn50", "patchout", "async", "dp", "grad_cache", "mp_model", "mp_pipe",
         "mp_seq", "mp_serve", "mp_serve_int8")
# the other backbones and patchout (backbone_phase): the DeiT VA step (the audio tower trainable at
# T = 99 x 12 + 2 = 1,190, the image tower frozen at T = 14 x 14 + 2 = 198), the RN50 VA step, and
# the flagship step with patchout 0.25 (305 patches, 228 kept, T = 229)
DEIT_B, DEIT_T, DEIT_IMAGE_T, PATCHOUT_T = 64, 1190, 198, 229
# the model axis of 2 in mp_phase: (tower, rows, width) of the trained audio tower's step at B = 16,
# the serving batch of 64 and the text tower (4 captions packed to T = 308) at batch 64
TP_TOWERS = (("audio B16 T306", 16 * 306, 768), ("audio B64 T306", 64 * 306, 768),
             ("text B16 T308", 16 * 308, 512))
# every product shape the paths give gemm_bias_act: (case, M, N, K, activation, residual, fp32
# pre-activation). The kernel phase holds each to its plain version; experiments/kernel_times.py
# times each, parent against change.
GEMM_FWD_CASES = [
    *[(f"{tower} {p}", M, N, K, act, res, False)
      for tower, M, C in (("audio B4 T306", 4 * 306, 768), ("text B1 T308", 308, 512),
                          ("image B1 T200", 200, 768), ("audio B64 T306", 64 * 306, 768))
      for p, N, K, act, res in (("qkv", 3 * C, C, "none", False), ("out+res", C, C, "none", True))],
    *[(f"{tower} {p}", M, N, K, act, res, False)
      for tower, M, C in (("audio B4 T306", 4 * 306, 768), ("text B1 T308", 308, 512),
                          ("audio B64 T306", 64 * 306, 768))
      for p, N, K, act, res in (("fc+quick_gelu", 4 * C, C, "quick_gelu", False),
                                ("fc+gelu", 4 * C, C, "gelu", False), ("proj+res", C, 4 * C, "none", True))],
    ("audio B64 T306 fc recompute, fp32 preact", 64 * 306, 3072, 768, "quick_gelu", False, True),
    ("image B64 (16 x T200) qkv", 16 * 200, 2304, 768, "none", False, False),   # the VA step's frozen tower
    ("image B64 (16 x T200) fc+quick_gelu", 16 * 200, 3072, 768, "quick_gelu", False, False),
    *[(f"caption decoder B64 T77 {p}", 64 * 77, N, K, act, res, False)           # the captioning step
      for p, N, K, act, res in (("qkv", 1536, 512, "none", False), ("out+res", 512, 512, "none", True),
                                ("fc+quick_gelu", 2048, 512, "quick_gelu", False),
                                ("proj+res", 512, 2048, "none", True))],
    *[(f"caption decode T=1 M={M} {p}", M, N, K, act, res, False)                # KV-cached decode: the MLP
      for M in (4, 16, 64, 256)
      for p, N, K, act, res in (("fc+quick_gelu", 2048, 512, "quick_gelu", False),
                                ("proj+res", 512, 2048, "none", True))],
    # the AT step at B = 50: the audio tower (M = 15,300, no multiple of 128), the frozen text tower
    # and its eval batch of 5 captions a clip
    *[(f"{tower} {p}", M, N, K, act, res, False)
      for tower, M, C in (("audio B50 T306", LA_B * 306, 768), ("text B50 T77", LA_B * 77, 512),
                          ("text B250 T77 (eval)", 5 * LA_B * 77, 512))
      for p, N, K, act, res in (("qkv", 3 * C, C, "none", False), ("out+res", C, C, "none", True),
                                ("fc+quick_gelu", 4 * C, C, "quick_gelu", False),
                                ("proj+res", C, 4 * C, "none", True))],
    ("audio B50 T306 fc recompute, fp32 preact", LA_B * 306, 3072, 768, "quick_gelu", False, True),
    # the trimodal step's image tower with its encoder tied to the trained audio tower (phase 20):
    # not packed, M = 64 x 50 = 3,200 (the packed frozen tower's qkv and fc above have these rows)
    *[(f"image B64 T50 {p}", 64 * 50, N, K, act, res, False)
      for p, N, K, act, res in (("out+res", 768, 768, "none", True), ("proj+res", 768, 3072, "none", True))],
    ("image B64 T50 fc recompute, fp32 preact", 64 * 50, 3072, 768, "quick_gelu", False, True),
    # backbone_phase: the DeiT step's trained audio tower (exact GELU, M = 76,160) and frozen image
    # tower (M = 12,672), the patchout step's audio tower (M = 64 x 229 = 14,656)
    *[(f"{tower} {p}", M, N, K, act, res, pre)
      for tower, M, mlp in ((f"DeiT audio B64 T{DEIT_T}", DEIT_B * DEIT_T, "gelu"),
                            (f"DeiT image B64 T{DEIT_IMAGE_T}", DEIT_B * DEIT_IMAGE_T, "gelu"),
                            (f"patchout audio B64 T{PATCHOUT_T}", 64 * PATCHOUT_T, "quick_gelu"))
      for p, N, K, act, res, pre in (("qkv", 2304, 768, "none", False, False),
                                     ("out+res", 768, 768, "none", True, False),
                                     (f"fc+{mlp}", 3072, 768, mlp, False, False),
                                     ("proj+res", 768, 3072, "none", True, False),
                                     (f"fc recompute, fp32 preact ({mlp})", 3072, 768, mlp, False, True))
      if not (pre and "image" in tower)],
    # mp_phase's model axis of 2 (TP_TOWERS): each rank's head block and hidden columns; the out and
    # proj products keep their fp32 partial (summed over the model group, then the residual added)
    *[(f"{tower} tp2 {p}", M, N, K, act, False, pre)
      for tower, M, C in TP_TOWERS
      for p, N, K, act, pre in (("qkv", 3 * C // 2, C, "none", False),
                                ("out, fp32 partial", C, C // 2, "none", True),
                                ("fc+quick_gelu", 2 * C, C, "quick_gelu", False),
                                ("proj, fp32 partial", C, 2 * C, "none", True),
                                ("fc recompute, fp32 preact", 2 * C, C, "quick_gelu", True))],
]
# every product shape the training paths give gemm_dgrad: (case, M, N, K, activation whose grad
# multiplies the product, rounded to bf16). dy [M, K] . w [K, N]: the attention's do = g.Wout and
# dh = dqkv.Wqkv, the MLP's da = (gy.Wproj) * act'(a) and dh = da.Wfc, for the audio tower at
# batch 4, 64 and 50 (the AT step) and the caption decoder at B64 T77. The backward kernel phase
# holds each to its plain version; experiments/kernel_times.py times each. The trimodal step's tied
# image tower (B64 T50) trains too.
GEMM_DGRAD_CASES = [
    (f"{tower} {p}", M, N, K, act, rounded)
    for tower, M, C in (("audio B4 T306", 4 * 306, 768), ("audio B64 T306", 64 * 306, 768),
                        ("caption decoder B64 T77", 64 * 77, 512), ("audio B50 T306", LA_B * 306, 768),
                        ("image B64 T50", 64 * 50, 768), (f"DeiT audio B64 T{DEIT_T}", DEIT_B * DEIT_T, 768),
                        (f"patchout audio B64 T{PATCHOUT_T}", 64 * PATCHOUT_T, 768))
    for p, N, K, act, rounded in (("do=g.Wout", C, C, "none", True),
                                  ("dh=dqkv.Wqkv fp32", C, 3 * C, "none", False),
                                  ("da=(gy.Wproj)*quick_gelu'(a)", 4 * C, C, "quick_gelu", True),
                                  ("da=(gy.Wproj)*gelu'(a)", 4 * C, C, "gelu", True),
                                  ("dh=da.Wfc fp32", C, 4 * C, "none", False))] + [  # mp_phase's model axis of 2: the trained audio tower's shard products (each dh fp32, summed
    # over the model group before the LayerNorm backward)
    ("audio B16 T306 tp2 " + p, 16 * 306, N, K, act, rounded)
    for p, N, K, act, rounded in (("do=g.Wout", 384, 768, "none", True),
                                  ("dh=dqkv.Wqkv fp32", 768, 1152, "none", False),
                                  ("da=(gy.Wproj)*quick_gelu'(a)", 1536, 768, "quick_gelu", True),
                                  ("dh=da.Wfc fp32", 768, 1536, "none", False))
]
# every product shape the int8 paths give gemm_i8: (case, M, N, K, activation, residual, fp32 out,
# column scale first). xq [M, K] . wq [N, K]^T: qkv, out + residual, fc + activation (fp32 out) and
# proj + residual, for the audio tower at batch 4 and 64, the text tower (4 captions packed to
# T = 308) at batch 4 and 64, and the frozen image tower of the VA step (16 x T200). The int8
# kernel phase holds each to its plain version; experiments/kernel_times.py times each.
GEMM_I8_CASES = [
    (f"{tower} {p}", M, N, K, act, res, f32, col_first)
    for tower, M, C in (("audio B4 T306", 4 * 306, 768), ("audio B64 T306", 64 * 306, 768),
                        ("text B1 T308", 308, 512), ("text B16 T308", 16 * 308, 512),
                        ("image B16 (x T200)", 16 * 200, 768))
    for p, N, K, act, res, f32, col_first in (("qkv", 3 * C, C, "none", False, False, True),
                                              ("out+res", C, C, "none", True, False, False),
                                              ("fc+quick_gelu fp32", 4 * C, C, "quick_gelu", False, True, False),
                                              ("fc+gelu fp32", 4 * C, C, "gelu", False, True, False),
                                              ("proj+res", C, 4 * C, "none", True, False, False))] + [  # int8 model-parallel serving: each rank's slices, the out and proj partials in fp32
    (f"{tower} tp2 {p}", M, N, K, act, False, f32, col_first)
    for tower, M, C in TP_TOWERS[1:]
    for p, N, K, act, f32, col_first in (("qkv", 3 * C // 2, C, "none", False, True),
                                         ("out fp32", C, C // 2, "none", True, False),
                                         ("fc+quick_gelu fp32", 2 * C, C, "quick_gelu", True, False),
                                         ("proj fp32", C, 2 * C, "none", True, False))
]
# every (rows, C) the seven paths give layernorm_fwd, and the int8 paths layernorm_rowquant: (case,
# rows, C). The forward kernel phase holds layernorm_fwd, the int8 kernel phase layernorm_rowquant
# (bitwise rowquant(layernorm_fwd(x))) to its plain version at each; experiments/kernel_times.py
# times each.
LAYERNORM_CASES = [
    ("audio B4 T306", 4 * 306, 768),                          # serving batch, captioning's audio tower
    ("text B1 T308", 308, 512),                               # 4 captions packed
    ("image B1 T200", 200, 768),                              # 4 images packed
    ("audio B64 T306", 64 * 306, 768),                        # the timed training steps, serving batch 64
    ("audio B16 T306", 16 * 306, 768),                        # the counted training steps
    ("image B64 (16 x T200)", 16 * 200, 768),                 # the VA step's frozen tower
    ("image B16 (4 x T200)", 4 * 200, 768),
    ("text B16 T308 = caption decoder B64 T77", 64 * 77, 512),  # M = 4,928 both
    ("caption decoder B16 T77", 16 * 77, 512),
    *[(f"caption decode T=1 M={M}", M, 512) for M in (4, 16, 64, 256)],  # KV-cached decode, the MLP
    ("audio B50 T306", LA_B * 306, 768),                      # the AT step and its eval
    ("text B50 T77", LA_B * 77, 512),                         # the AT step's frozen text tower
    ("text B250 T77 (AT eval, 5 captions a clip)", 5 * LA_B * 77, 512),
    (f"DeiT audio B64 T{DEIT_T}", DEIT_B * DEIT_T, 768),           # backbone_phase: the DeiT step
    (f"DeiT image B64 T{DEIT_IMAGE_T}", DEIT_B * DEIT_IMAGE_T, 768),
    (f"DeiT audio B16 T{DEIT_T}", 16 * DEIT_T, 768),               # its grad check
    (f"patchout audio B64 T{PATCHOUT_T}", 64 * PATCHOUT_T, 768),  # the patchout step
    (f"patchout audio B16 T{PATCHOUT_T}", 16 * PATCHOUT_T, 768),
]
# every (rows, C) the training paths give layernorm_bwd (two launches a layer of a trained tower: the
# attention and the MLP sub-block): (case, rows, C). The backward kernel phase holds it to its plain
# version at each, dw and db bitwise across two runs and db bitwise to layernorm_bwd_ordered, with
# device us per call beside autograd through F.layer_norm; experiments/kernel_times.py times each.
LAYERNORM_BWD_CASES = [
    ("audio B64 T306", 64 * 306, 768),             # the timed VA and captioning steps
    ("audio B4 T306", 4 * 306, 768),
    ("audio B16 T306", 16 * 306, 768),             # the counted training steps
    ("caption decoder B64 T77", 64 * 77, 512),     # the timed captioning step, M = 4,928
    ("caption decoder B16 T77", 16 * 77, 512),     # the counted captioning step
    ("text B1 T308", 308, 512),                    # 4 captions packed
    ("audio B50 T306", LA_B * 306, 768),           # the AT step, M = 15,300
    ("image B64 T50", 64 * 50, 768),               # the trimodal step's tied image tower, M = 3,200
    (f"DeiT audio B64 T{DEIT_T}", DEIT_B * DEIT_T, 768),           # backbone_phase's trained towers
    (f"patchout audio B64 T{PATCHOUT_T}", 64 * PATCHOUT_T, 768),
]
# the flash kernel phase's shapes: (case, B, Tq, Tk, H, bias: None, "pack" (4 items of T / 4
# tokens, block-diagonal) or "causal"); the first is the captioning step's cross-attention.
# experiments/kernel_times.py times flash_attention_fwd and _bwd at each, _dbias at each with a bias.
FLASH_CASES = [
    ("cross B64 Tq77 Tk61 H8", 64, 77, 61, 8, None),
    ("cross B4 Tq77 Tk61 H8", 4, 77, 61, 8, None),
    ("re-forward decode B64 Tq32 Tk61 H8", 64, 32, 61, 8, None),
    ("re-forward decode B4 Tq32 Tk61 H8", 4, 32, 61, 8, None),
    ("self B16 T971 H12 (patch 32, stride 10x10)", 16, 971, 971, 12, None),
    ("self B16 T200 H12 pack, bias grad", 16, 200, 200, 12, "pack"),
    ("self B64 T77 H8 causal", 64, 77, 77, 8, "causal"),
]
# every (rows, N, dtype) of the trained towers' four bias grads: dbout and dbproj (the output grad,
# [M, C] bf16), dbqkv (the fp32 dqkv, [M, 3C]), dbfc (the rounded da, [M, 4C] bf16), for the audio
# tower at batch 64, 4 and 50 (the AT step) and the caption decoder at B64 T77. The backward kernel
# phase holds colsum to its plain version at each, bitwise across two runs and to colsum_ordered;
# experiments/kernel_times.py times each.
COLSUM_CASES = [
    (f"{tower} {p}", M, N, dtype)
    for tower, M, C in (("audio B64 T306", 64 * 306, 768), ("audio B4 T306", 4 * 306, 768),
                        ("caption decoder B64 T77", 64 * 77, 512), ("audio B50 T306", LA_B * 306, 768),
                        ("image B64 T50", 64 * 50, 768), (f"DeiT audio B64 T{DEIT_T}", DEIT_B * DEIT_T, 768),
                        (f"patchout audio B64 T{PATCHOUT_T}", 64 * PATCHOUT_T, 768))
    for p, N, dtype in (("dbout, dbproj", C, "bf16"), ("dbqkv fp32", 3 * C, "fp32"), ("dbfc", 4 * C, "bf16"))
]
# the towers the int8 paths run, by rows a call: (case, rows, C). Serving: audio at batch 4, 16 and
# 64, text (4 captions packed to T = 308) at batch 4 and 64; the VA step's frozen int8 image tower
# (4 images packed to T = 200) at B = 64 and 16.
INT8_TOWERS = [
    ("audio B4 T306", 4 * 306, 768), ("audio B16 T306", 16 * 306, 768), ("audio B64 T306", 64 * 306, 768),
    ("text B1 T308", 308, 512), ("text B16 T308", 16 * 308, 512),
    ("image B64 (16 x T200)", 16 * 200, 768), ("image B16 (4 x T200)", 4 * 200, 768),
]
# every (rows, K, dtype) the int8 paths give rowquant: (case, rows, K, dtype). Per tower width the
# four weights, quantized per output column (a row of the torch [out, in] layout): Wqkv and Wout cast
# to bf16, Wfc and Wproj fp32; per tower and batch the fp32 attention context [M, C] and the fp32
# act(a) [M, 4C]. The int8 kernel phase holds rowquant to its plain version at each, bitwise;
# experiments/kernel_times.py times each.
ROWQUANT_CASES = [
    *[(f"C{C} {p}", N, K, dtype) for C in (768, 512)
      for p, N, K, dtype in (("Wqkv bf16", 3 * C, C, "bf16"), ("Wout bf16", C, C, "bf16"),
                             ("Wfc fp32", 4 * C, C, "fp32"), ("Wproj fp32", C, 4 * C, "fp32"))],
    *[(f"{tower} {p}", M, K, "fp32") for tower, M, C in INT8_TOWERS
      for p, K in (("context", C), ("act(a)", 4 * C))],    # int8 model-parallel serving: each rank's weight slices and its heads' and columns' activations
    *[(f"C{C} tp2 {p}", N, K, dtype) for C in (768, 512)
      for p, N, K, dtype in (("Wqkv bf16", 3 * C // 2, C, "bf16"), ("Wout bf16", C, C // 2, "bf16"),
                             ("Wfc fp32", 2 * C, C, "fp32"), ("Wproj fp32", C, 2 * C, "fp32"))],
    *[(f"{tower} tp2 {p}", M, K, "fp32") for tower, M, C in TP_TOWERS[1:]
      for p, K in (("context", C // 2), ("act(a)", 2 * C))],
]
# dot_variant's shapes: (case, M, K, N). The probe's product (fused_block_probe.DOT_MKN, the only
# shape a path launches), one of multiples of 16 that are not of 64, and one whose K takes more than
# one stage of the kernel's ring. The probe phase holds each orientation to its plain version at
# each; experiments/kernel_times.py times each.
DOT_CASES = [
    ("probe M256 K128 N384", 256, 128, 384),
    ("ragged M80 K32 N48", 80, 32, 48),
    ("deep M256 K1024 N384", 256, 1024, 384),
]
def TP_ATTENTION_CASES(torch):
    """The attention kernels' shapes on a model axis of 2 (mp_phase): the trained audio tower's 6
    heads of 12 at B = 16, the text tower's 4 of 8 (causal, 4 captions packed) at batch 64."""
    _, text_bias = _biases(torch)
    return (("audio B16 T306 C384 H6 (tp2)", 16, 306, 384, 6, None),
            ("text B16 T308 C256 H4 causal+pack (tp2)", 16, 308, 256, 4, text_bias))


# patch_gather at the main paths' inputs: (case, B, Cin, H, W, patch, stride), fp32 in, bf16 rows out
PATCH_CASES = [
    ("VA audio B432", 432, 1, 1000, 128, (32, 32), (16, 24)),
    ("VA image B432", 432, 3, 224, 224, (32, 32), (32, 32)),
    ("embed audio B64", 64, 1, 1000, 128, (32, 32), (16, 24)),
    ("AT audio B50", LA_B, 1, 1000, 128, (32, 32), (16, 24)),
    ("DeiT audio B64 (stride 10)", DEIT_B, 1, 1000, 128, (16, 16), (10, 10)),
]
ATTENTION_STREAMING_T = (705, 971, DEIT_T)  # attention_fwd past the 704 keys it keeps resident
DECODE_TOL = 0.1  # bf16 per-step logits, KV-cached against re-forward decoding
DOT_TOL = 1e-3  # dot_variant: fp32 sums of up to 1024 bf16 products, in another order than the plain one
# H100 SXM data sheet, dense rates: the bounds are stated against these
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
FLIP_SHARE = 1e-3  # int8 codes that may be off by one against the plain version
INT8_COS_MIN = 0.99  # an int8 tower against its bf16 self (the JAX package's bar)


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _outputs(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,)) if t is not None]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes, ops):
    """The least time in ms the card could take: ``nbytes`` over its memory
    rate, or ``ops``, a list of (count, type), each over the peak rate for
    its type, whichever is larger, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for n, kind in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_default(torch, got, want, what):
    """bf16 outputs at atol = rtol = 2e-2, fp32 outputs at max |d| <= 1e-2 *
    max |plain|; returns (max |d|, its description per output)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, plain has {len(want)}")
    errs, worst = [], 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} output {i}: {g.dtype} {tuple(g.shape)} vs "
                                 f"{w.dtype} {tuple(w.shape)}, finite {bool(torch.isfinite(g).all())}")
        d = (g.float() - w.float()).abs()
        err, scale = d.max().item(), w.float().abs().max().item()
        if g.dtype == torch.bfloat16:
            ok = torch.allclose(g.float(), w.float(), atol=ATOL, rtol=RTOL)
            errs.append(f"{err:.2e}")
        else:
            ok = err <= REL * scale
            errs.append(f"{err:.2e}(rel {err / max(scale, 1e-30):.1e})")
        if not ok:
            raise AssertionError(f"{what} output {i}: kernel disagrees with its plain "
                                 f"version (max|d| {err:.3e}, max|plain| {scale:.3e})")
        worst = max(worst, err)
    return worst, " ".join(errs)


def check_codes(torch, got, want, what):
    """(int8 codes, fp32 scales) against the plain version's: scales to 1e-6
    relative; codes equal except a share of at most FLIP_SHARE off by exactly
    one. Returns (max |d| of the dequantized values, description)."""
    (q, s), (q0, s0) = got, want
    if q.dtype != torch.int8 or q.shape != q0.shape or s.shape != s0.shape:
        raise AssertionError(f"{what}: codes {q.dtype} {tuple(q.shape)}, scales {tuple(s.shape)}")
    if not torch.allclose(s, s0, rtol=1e-6, atol=0):
        raise AssertionError(f"{what}: scales differ by {(s - s0).abs().max().item():.3e}")
    d = (q.int() - q0.int()).abs()
    off, share = d.max().item(), (d != 0).float().mean().item()
    if off > 1 or share > FLIP_SHARE:
        raise AssertionError(f"{what}: codes off by up to {off}, share {share:.2e} > {FLIP_SHARE}")
    err = (q.float() * s - q0.float() * s0).abs().max().item()
    return err, f"codes: {share:.1e} off by one; dequantized {err:.2e}"


def check_bitwise(torch, got, want, what):
    """Every output bitwise the plain version's."""
    if len(got) != len(want) or not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: not bitwise its plain version")
    return 0.0, "bitwise"


def device_us(torch, fn, calls=20, tries=3):
    """Device time per call in µs, from a profiler window of ``calls``
    calls: each kernel's mean duration times the launches a call makes of
    it. Where a loop of calls is bound by the host, this is the number to
    compare. A window can lose device events (windows taken after the
    training phases see 14 to 19 of 20 launches; earlier, one window in a
    few dozen saw a few, and its busy time read far too low), so a call's
    launches of a kernel are its count in the window over ``calls``,
    rounded, and a kernel seen fewer than ``calls / 2`` times is not the
    calls' own. A window with none is tried again; None means not
    measured."""
    seen = {}
    for _ in range(tries):
        try:
            _, _, seen = _profile(torch, fn, calls)
        except AssertionError:
            continue
        per_call = [(round(n / calls), ms / n) for n, ms in seen.values()]
        if any(k for k, _ in per_call):
            return sum(k * mean for k, mean in per_call) * 1e3
    print(f"  device_us: no window saw the calls' kernels in {tries}; the last: "
          + ", ".join(f"{k[:40]} x{n}" for k, (n, _) in seen.items()))
    return None


def compare(torch, results, name, case, fn, plain, reads=(), ops=(), library=None, check=None,
            also=None, iters=10, device=False):
    """Hold ``fn()`` (kernels) to ``plain()`` (``check``, by default output
    by output), time both (CUDA events, order plain, kernel, kernel)
    and record the result under ``name``, beside the bound from ``reads``
    (the input tensors; the outputs are taken from the run) and ``ops``, the
    time of ``library()`` if given, and of each callable in ``also``; with
    ``device``, also the device µs per call of the kernel and the library
    call (``device_us``). Raises on any disagreement."""
    got, want = _outputs(fn()), _outputs(plain())
    torch.cuda.synchronize()
    case_err, errs = (check or check_default)(torch, got, want, f"{name} {case}")
    plain_ms = cuda_ms(torch, plain, iters)
    tk1 = cuda_ms(torch, fn, iters)
    tk2 = cuda_ms(torch, fn, iters)
    ms = (tk1 + tk2) / 2
    bound_ms, bound_by = bound(_nbytes(reads) + _nbytes(got), ops)
    library_ms = None
    if library is not None:
        try:
            library_ms = cuda_ms(torch, library, iters)
        except RuntimeError as e:  # a yardstick outside the port: report, do not fail the port
            print(f"  library call for {name} {case} refused: {str(e).splitlines()[0]}")
    extra = {k: cuda_ms(torch, f, iters) for k, f in (also or {}).items()}
    if device:
        extra["device_us"] = device_us(torch, fn)
        if library_ms is not None:
            extra["library_device_us"] = device_us(torch, library)
    num = lambda v: "-" if v is None else f"{v:.4f}"
    print(f"  {name:30s} {case:44s} ms={ms:.4f} plain={plain_ms:.4f} bound={bound_ms:.4f}({bound_by[:5]}) "
          f"library={num(library_ms)}" + "".join(f" {k}={num(v)}" for k, v in extra.items()) + f" max|d|={errs}")
    r = results.setdefault(name, {"max_abs_err": 0.0, "cases": [], "launches": {}})
    r["max_abs_err"] = max(r["max_abs_err"], case_err)
    r["cases"].append({"case": case, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms, "max_abs_err": case_err,
                       **extra})


@contextlib.contextmanager
def plain_ops():
    """Every fused sub-block, bf16 and int8, the ring's attention sub-block
    and the flash attention under the dispatcher on their plain versions,
    forward and backward."""
    from vipant_tpu_torch.ops import attention, fused_attn, fused_mlp
    from vipant_tpu_torch.parallel import sequence

    with contextlib.ExitStack() as stack:
        for mod, names in ((fused_attn, ("fused_ln_attention_block", "fused_ln_attention_block_int8")),
                           (fused_mlp, ("fused_ln_mlp_block", "fused_ln_mlp_block_int8")),
                           (attention, ("flash_attention",)), (sequence, ("ring_ln_attention_block",))):
            for n in names:
                stack.enter_context(mock.patch.object(mod, n, getattr(mod, n + "_plain")))
        yield


def _seeded(torch):
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    return rn


def _biases(torch):
    from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens

    pack_bias = lambda T, k: pack_tokens(torch.zeros(k, T, 1, device="cuda"), k)[1]
    return pack_bias, causal_mask(4 * 77, device="cuda") + pack_bias(77, 4)


def flash_bias(torch, kind, T):
    """The [T, T] fp32 bias of a ``FLASH_CASES`` kind, finite (the causal
    mask clamped at -1e30), or None."""
    from vipant_tpu_torch.nn.layers import causal_mask

    if kind is None:
        return None
    if kind == "causal":
        return torch.clamp(causal_mask(T, device="cuda"), min=-1e30).contiguous()
    return _biases(torch)[0](T // 4, 4)


def gemm_ops(M, N, K, kind="bf16"):
    return [(2 * M * N * K, kind)]


def attn_ops(B, T, H, products=2):
    """``products`` T x T x 64 products per head: 2 forward (q.k^T, p.v), 5
    backward (scores, dp, dv, dq, dk)."""
    return [(products * 2 * B * H * T * T * 64, "bf16")]


def _sdpa(torch, qkv, cb, H, scale):
    """The library's attention on the packed projection: q, k, v as views."""
    B, T, C3 = qkv.shape
    q, k, v = qkv.view(B, T, 3, H, C3 // 3 // H).permute(2, 0, 3, 1, 4)
    mask = None if cb is None else cb.to(qkv.dtype)
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _sdpa_bwd(torch, qkv, cb, H, scale, do):
    """The library's attention backward for the output grad ``do`` [B, T, C]:
    autograd through ``scaled_dot_product_attention`` to q, k and v."""
    B, T, C3 = qkv.shape
    leaves = [t.detach().clone().requires_grad_()
              for t in qkv.view(B, T, 3, H, C3 // 3 // H).permute(2, 0, 3, 1, 4)]
    mask = None if cb is None else cb.to(qkv.dtype)
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
    g = do.view(B, T, H, C3 // 3 // H).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _layer_norm_bwd(torch, x, w, dh):
    """The library's LayerNorm backward: autograd through ``F.layer_norm`` in
    bf16 to x, the weight and the bias, for the output grad ``dh``."""
    C = x.shape[-1]
    leaves = [x.detach().clone().requires_grad_(), w.bfloat16().requires_grad_(),
              torch.zeros(C, dtype=torch.bfloat16, device=x.device, requires_grad=True)]
    y = torch.nn.functional.layer_norm(leaves[0], (C,), leaves[1], leaves[2])
    g = dh.to(y.dtype)
    return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)


def kernel_phase(torch, results):
    from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels

    F = torch.nn.functional
    rn = _seeded(torch)
    pack_bias, text_bias = _biases(torch)
    # layernorm_fwd at every (rows, C) the paths give it
    for case, M, C in LAYERNORM_CASES:
        x = rn(M, C)
        lns, lnb = 1 + rn(C, std=0.1, dtype=torch.float32), rn(C, std=0.1, dtype=torch.float32)
        lns_b, lnb_b = lns.bfloat16(), lnb.bfloat16()
        compare(torch, results, "layernorm_fwd", f"{case} [{M}x{C}]", lambda: kernels.layernorm_fwd(x, lns, lnb),
                lambda: kernels.layernorm_plain(x, lns, lnb), reads=(x, lns, lnb), ops=[(8 * M * C, "fp32")],
                library=lambda: F.layer_norm(x, (C,), lns_b, lnb_b), iters=5 if M > 5000 else 10, device=True)

    attn_cases = [  # (case, B, T, C, H, bias): audio, packed text, packed image, audio at batch 64
        ("audio B4 T306 C768 H12", BATCH, 306, 768, 12, None),
        ("text B1 T308 C512 H8 causal+pack", 1, 308, 512, 8, text_bias),
        ("image B1 T200 C768 H12 pack", 1, 200, 768, 12, pack_bias(50, 4)),
        ("audio B64 T306 C768 H12", 64, 306, 768, 12, None),
    ]
    for case, B, T, C, H, bias in attn_cases:
        cmp = lambda *a, **k: compare(torch, results, *a, iters=5 if B > BATCH else 10, **k)
        M = B * T
        x = rn(B, T, C)
        lns, lnb = 1 + rn(C, std=0.1, dtype=torch.float32), rn(C, std=0.1, dtype=torch.float32)
        wqkv, bqkv = rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.02, dtype=torch.float32)
        wout, bout = rn(C, C, std=C ** -0.5), rn(C, std=0.02, dtype=torch.float32)
        cb = fused_attn.canon_bias(bias)
        h = kernels.layernorm_plain(x, lns, lnb)
        qkv = kernels.gemm_bias_act_plain(h, wqkv, bqkv)
        o = kernels.attention_plain(qkv, cb, H, 0.125)
        args = (x, lns, lnb, wqkv, bqkv, wout, bout, bias, H)
        cmp("attention_fwd", case, lambda: kernels.attention_fwd(qkv, cb, H, 0.125),
            lambda: kernels.attention_plain(qkv, cb, H, 0.125), reads=(qkv, cb),
            ops=attn_ops(B, T, H), library=_sdpa(torch, qkv, cb, H, 0.125))
        cmp("fused_ln_attention_block", case,
            lambda: fused_attn.fused_ln_attention_block(*args),
            lambda: fused_attn.fused_ln_attention_block_plain(*args), reads=args[:8],
            ops=gemm_ops(M, 3 * C, C) + attn_ops(B, T, H) + gemm_ops(M, C, C))

    for case, B, T, C in (("audio B4 T306 C768 E3072", BATCH, 306, 768),
                          ("text B1 T308 C512 E2048", 1, 308, 512),
                          ("audio B64 T306 C768 E3072", 64, 306, 768)):
        cmp = lambda *a, **k: compare(torch, results, *a, iters=5 if B > BATCH else 10, **k)
        E, M = 4 * C, B * T
        x = rn(B, T, C)
        lns, lnb = 1 + rn(C, std=0.1, dtype=torch.float32), rn(C, std=0.1, dtype=torch.float32)
        wfc, bfc = rn(E, C, std=C ** -0.5), rn(E, std=0.02, dtype=torch.float32)
        wproj, bproj = rn(C, E, std=E ** -0.5), rn(C, std=0.02, dtype=torch.float32)
        args = (x, lns, lnb, wfc, bfc, wproj, bproj, "quick_gelu")
        cmp("fused_ln_mlp_block", case, lambda: fused_mlp.fused_ln_mlp_block(*args),
            lambda: fused_mlp.fused_ln_mlp_block_plain(*args), reads=args[:7],
            ops=gemm_ops(M, E, C) + gemm_ops(M, C, E))

    # gemm_bias_act alone at every shape the paths give it, bitwise equal over two runs
    for case, B, T, C, H, bias in TP_ATTENTION_CASES(torch):  # mp_phase's head blocks on a model axis of 2
        qkv, cb = rn(B, T, 3 * C), fused_attn.canon_bias(bias)
        compare(torch, results, "attention_fwd", case, lambda: kernels.attention_fwd(qkv, cb, H, 0.125),
                lambda: kernels.attention_plain(qkv, cb, H, 0.125), reads=(qkv, cb),
                ops=attn_ops(B, T, H), library=_sdpa(torch, qkv, cb, H, 0.125), iters=10)

    for case, M, N, K, act, res, pre in GEMM_FWD_CASES:
        x, w, b = rn(M, K), rn(N, K, std=K ** -0.5), rn(N, std=0.02, dtype=torch.float32)
        r, bb = (rn(M, N) if res else None), b.bfloat16()
        compare(torch, results, "gemm_bias_act", f"{case} [{M}x{N}x{K}]",
                lambda: kernels.gemm_bias_act(x, w, b, act, r, pre),
                lambda: kernels.gemm_bias_act_plain(x, w, b, act, r, pre), reads=(x, w, b, r),
                ops=gemm_ops(M, N, K), library=lambda: F.linear(x, w, bb), iters=5 if M > 5000 else 10)
        if not all(torch.equal(u, v) for u, v in zip(_outputs(kernels.gemm_bias_act(x, w, b, act, r, pre)),
                                                     _outputs(kernels.gemm_bias_act(x, w, b, act, r, pre)))):
            raise AssertionError(f"gemm_bias_act {case}: two runs differ")

    # patch_gather at the towers' inputs, bitwise its plain version and across two runs; the library
    # call is the path it replaced: the input rounded to bf16, then F.unfold's per-item im2col; beside
    # them, one TensorIterator copy of the input's unfold view into F.unfold's layout, rounding
    def unfold_copy(x, patch, stride):
        v = x.unfold(2, patch[0], stride[0]).unfold(3, patch[1], stride[1])  # [B, C, nrow, ncol, ph, pw]
        out = torch.empty((*v.shape[:2], *patch, *v.shape[2:4]), dtype=torch.bfloat16, device=x.device)
        return out.copy_(v.permute(0, 1, 4, 5, 2, 3)).view(x.shape[0], -1, v.shape[2] * v.shape[3])

    for case, B, Cin, H, W, patch, stride in PATCH_CASES:
        x = rn(B, Cin, H, W, dtype=torch.float32)
        shape = f"{B}x{Cin}x{H}x{W} {patch[0]}x{patch[1]}/{stride[0]}x{stride[1]}"
        compare(torch, results, "patch_gather", f"{case} [{shape}]",
                lambda: kernels.patch_gather(x, patch, stride), lambda: kernels.patch_gather_plain(x, patch, stride),
                reads=(x,), library=lambda: F.unfold(x.to(torch.bfloat16), patch, stride=stride),
                check=check_bitwise, also={"unfold_copy_ms": lambda: unfold_copy(x, patch, stride)},
                iters=5 if B > 64 else 10, device=True)
        if not torch.equal(kernels.patch_gather(x, patch, stride), kernels.patch_gather(x, patch, stride)):
            raise AssertionError(f"patch_gather {case}: two runs differ")
        del x
        torch.cuda.empty_cache()

    # attention_fwd's streaming form (T > 704: keys and values pass through the block in tiles of
    # 64), which the DeiT audio tower launches at T = 1,190 (backbone_phase)
    for T in ATTENTION_STREAMING_T:
        B, C, H = 16, 768, 12
        qkv = rn(B, T, 3 * C)
        compare(torch, results, "attention_fwd", f"B{B} T{T} C{C} H{H}, streaming (T > 704)",
                lambda: kernels.attention_fwd(qkv, None, H, 0.125),
                lambda: kernels.attention_plain(qkv, None, H, 0.125), reads=(qkv,),
                ops=attn_ops(B, T, H), library=_sdpa(torch, qkv, None, H, 0.125), iters=10)
        del qkv
        torch.cuda.empty_cache()


def _block_bwd(torch, block, args, g, **kw):
    """Runs ``block(*args, **kw)`` forward once through its autograd boundary
    and returns a callable that reruns only the backward for the output grad
    ``g``: ``torch.autograd.grad`` with respect to every argument, the grads
    in the params' dtypes, as the training step gets them."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = block(*leaves, **kw)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def backward_p_is_forward_p(torch):
    """``attention_bwd`` recomputes p bitwise as ``attention_fwd`` computed
    it. With v one-hot on a window of 64 keys (v[j, d] = 1 iff j = w0 + d)
    the forward's output is o[i, d] = bf16(p[i, w0 + d]) exactly; with do
    one-hot on a window of 64 queries the backward's dv is dv[j, d] =
    bf16(p[r0 + d, j]) exactly (one nonzero term in each sum). The windows
    cross the kernels' tile edges; a T = 306 window runs past T."""
    from vipant_tpu_torch.nn.layers import causal_mask
    from vipant_tpu_torch.ops import fused_attn, kernels

    rn = _seeded(torch)
    pack_bias, _ = _biases(torch)
    B, H, C = 2, 2, 128
    for case, T, bias, w0, r0 in (("T64", 64, None, 0, 0), ("T306 pack", 306, pack_bias(153, 2), 40, 100),
                                  ("T77 causal", 77, causal_mask(77, device="cuda"), 10, 13),
                                  ("T306", 306, None, 250, 200)):
        cb = fused_attn.canon_bias(bias)
        nk, nq = min(64, T - w0), min(64, T - r0)
        qkv, do = rn(B, T, 3 * C), torch.zeros(B, T, H, 64, dtype=torch.bfloat16, device="cuda")
        v = qkv.view(B, T, 3, H, 64)[:, :, 2]
        v.zero_()
        v[:, w0 + torch.arange(nk), :, torch.arange(nk)] = 1
        do[:, r0 + torch.arange(nq), :, torch.arange(nq)] = 1
        o, stats = kernels.attention_fwd(qkv, cb, H, 0.125, stats=True)
        _, dqkv_b = kernels.attention_bwd(qkv, do.view(B, T, C), cb, H, 0.125, stats)
        p_fwd = o.view(B, T, H, 64)[:, r0:r0 + nq, :, :nk]                                  # [B, query, H, key]
        p_bwd = dqkv_b.view(B, T, 3, H, 64)[:, w0:w0 + nk, 2, :, :nq].permute(0, 3, 2, 1)
        share = (p_fwd != 0).float().mean().item()
        print(f"  C3 {case}, keys {w0}..{w0 + nk - 1}, queries {r0}..{r0 + nq - 1}: the backward's p "
              f"{'bitwise equal to' if torch.equal(p_fwd, p_bwd) else 'DIFFERS from'} the forward's "
              f"({100 * share:.1f} % nonzero)")
        if not torch.equal(p_fwd, p_bwd) or share < 0.25:
            raise AssertionError(f"C3 {case}: the backward's p is not the forward's "
                                 f"(max|d| {(p_fwd.float() - p_bwd.float()).abs().max().item():.3e})")


def backward_kernel_phase(torch, results):
    """Each backward kernel on the inputs its chain gives it, and each
    sub-block's backward through its autograd boundary, against the plain
    versions: at the serving path's shapes and at the training step's
    (audio B = 64, M = 19,584 rows)."""
    from vipant_tpu_torch.nn.layers import causal_mask
    from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels

    rn = _seeded(torch)
    _, text_bias = _biases(torch)

    # colsum at every bias grad of the trained towers, bitwise across two runs and equal to
    # colsum_ordered (the plain sum in the kernel's order); the case names the row split
    for case, M, N, dtype in COLSUM_CASES:
        x = rn(M, N, dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
        S, rows = kernels.colsum_split(M, N, x.element_size())
        blocks = S * -(-N * x.element_size() // kernels.COLSUM_STRIP)
        if M >= 64 * 77 and blocks < kernels.SM_COUNT:  # a training step's bias grad must fill the card
            raise AssertionError(f"colsum {case}: {blocks} blocks for {kernels.SM_COUNT} SMs")
        compare(torch, results, "colsum", f"{case} [{M}x{N} {dtype}: S={S} chunks of {rows} rows, {blocks} blocks]",
                lambda: kernels.colsum(x), lambda: kernels.colsum_plain(x), reads=(x,), ops=[(M * N, "fp32")],
                library=lambda: x.sum(0, dtype=torch.float32), iters=5 if M > 5000 else 10, device=True)
        got = kernels.colsum(x)
        if not (torch.equal(got, kernels.colsum(x)) and torch.equal(got, kernels.colsum_ordered(x))):
            raise AssertionError(f"colsum {case}: two runs differ, or the sum is not in colsum_ordered's order")
        del x
    print("  colsum: two runs bitwise equal, and equal to colsum_ordered, at every case")

    # layernorm_bwd at every (rows, C) the training paths give it, with the residual grad; dw and db
    # bitwise across two runs, db bitwise layernorm_bwd_ordered (the plain sum in the kernel's order)
    for case, M, C in LAYERNORM_BWD_CASES:
        x, dh, res = rn(M, C), rn(M, C, dtype=torch.float32), rn(M, C)
        w = 1 + rn(C, std=0.1, dtype=torch.float32)
        warps, rows = kernels.layernorm_bwd_split(M, C)
        if M >= 64 * 77 and warps < kernels.SM_COUNT * kernels.LN_BWD_WARPS:  # a training step fills the card
            raise AssertionError(f"layernorm_bwd {case}: {warps} warps for {kernels.SM_COUNT} SMs")
        call = lambda: kernels.layernorm_bwd(x, w, dh, res)
        compare(torch, results, "layernorm_bwd", f"{case} [{M}x{C}: {warps} warps of {rows} rows]", call,
                lambda: kernels.layernorm_bwd_plain(x, w, dh, res), reads=(x, w, dh, res),
                ops=[(20 * M * C, "fp32")], library=_layer_norm_bwd(torch, x, w, dh),
                iters=5 if M > 5000 else 10, device=True)
        (_, dw, db), (_, dw2, db2) = call(), call()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            raise AssertionError(f"layernorm_bwd {case}: two runs differ")
        if not torch.equal(db, kernels.layernorm_bwd_ordered(x, w, dh, res)[2]):
            raise AssertionError(f"layernorm_bwd {case}: db is not summed in layernorm_bwd_ordered's order")
        del x, dh, res
    print("  layernorm_bwd: dw and db bitwise equal across two runs, db equal to layernorm_bwd_ordered's, "
          "at every case")

    def wgrad(cmp, case, a, b):
        """``gemm_wgrad(a, b)`` beside ``torch.matmul`` of a^T . b; the case names the row split."""
        a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        M, N1, N2 = a2.shape[0], a2.shape[1], b2.shape[1]
        S, rows = kernels.wgrad_split(M, N1, N2)
        blocks = S * -(-N1 // kernels.WGRAD_TILE) * -(-N2 // kernels.WGRAD_TILE)
        if M >= 64 * 77 and blocks < kernels.SM_COUNT:  # a training step's product must fill the card
            raise AssertionError(f"gemm_wgrad {case}: {blocks} blocks for {kernels.SM_COUNT} SMs")
        cmp("gemm_wgrad", f"{case} [{N1}x{N2}, M={M}: S={S} chunks of {rows} rows, {blocks} blocks]",
            lambda: kernels.gemm_wgrad(a, b), lambda: kernels.gemm_wgrad_plain(a, b), reads=(a, b),
            ops=gemm_ops(M, N1, N2), library=lambda: torch.matmul(a2.t(), b2))
        if not torch.equal(kernels.gemm_wgrad(a, b), kernels.gemm_wgrad(a, b)):
            raise AssertionError(f"gemm_wgrad {case}: two runs differ")

    for case, B, T, C, H, bias in (("audio B4 T306 C768 H12", BATCH, 306, 768, 12, None),
                                   ("text B1 T308 C512 H8 causal+pack", 1, 308, 512, 8, text_bias),
                                   ("audio B64 T306 C768 H12 (train step)", 64, 306, 768, 12, None)):
        cmp = lambda *a, **k: compare(torch, results, *a, iters=5 if B > BATCH else 10, **k)
        M = B * T
        x, g = rn(B, T, C), rn(B, T, C)
        lns, lnb = 1 + rn(C, std=0.1, dtype=torch.float32), rn(C, std=0.1, dtype=torch.float32)
        wqkv, bqkv = rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.02, dtype=torch.float32)
        wout, bout = rn(C, C, std=C ** -0.5), rn(C, std=0.02, dtype=torch.float32)
        cb, scale = fused_attn.canon_bias(bias), 1.0 / (C // H) ** 0.5
        h = kernels.layernorm_plain(x, lns, lnb)
        qkv = kernels.gemm_bias_act_plain(h, wqkv, bqkv)
        o, stats = kernels.attention_fwd(qkv, cb, H, scale, stats=True)
        do = kernels.gemm_dgrad_plain(g, wout, True)
        dqkv, dqkv_b = kernels.attention_bwd_plain(qkv, do, cb, H, scale)
        dh = kernels.gemm_dgrad_plain(dqkv_b, wqkv, False)
        wgrad(cmp, case + " dWout", g, o)
        cmp("attention_bwd", case, lambda: kernels.attention_bwd(qkv, do, cb, H, scale, stats),
            lambda: kernels.attention_bwd_plain(qkv, do, cb, H, scale), reads=(qkv, do, cb, stats),
            ops=attn_ops(B, T, H, products=5), library=_sdpa_bwd(torch, qkv, cb, H, scale, do))
        wgrad(cmp, case + " dWqkv", dqkv_b, h)
        cmp("layernorm_bwd", case, lambda: kernels.layernorm_bwd(x, lns, dh, residual=g),
            lambda: kernels.layernorm_bwd_plain(x, lns, dh, residual=g), reads=(x, lns, dh, g),
            ops=[(20 * M * C, "fp32")], library=_layer_norm_bwd(torch, x, lns, dh))
        del qkv, o, stats, do, dqkv, dqkv_b, dh
        args = (x, lns, lnb, wqkv.float(), bqkv, wout.float(), bout)  # fp32 params, as trained
        cmp("fused_ln_attention_block_bwd", case,
            _block_bwd(torch, fused_attn.fused_ln_attention_block, args, g, bias=bias, heads=H),
            _block_bwd(torch, fused_attn.fused_ln_attention_block_plain, args, g, bias=bias, heads=H),
            reads=(*args, g, cb),
            ops=gemm_ops(M, C, C) * 2 + gemm_ops(M, 3 * C, C) * 2 + attn_ops(B, T, H, products=5))
        torch.cuda.empty_cache()

    # attention_bwd at the captioning decoder's self-attention, at a packed batch of images, at the
    # trimodal step's tied image tower and at mp_phase's head blocks of a model axis of 2
    pack_bias, _ = _biases(torch)
    for case, B, T, C, H, bias in (("decoder B64 T77 C512 H8 causal", 64, 77, 512, 8, causal_mask(77, device="cuda")),
                                   ("image B16 T200 C768 H12 pack", 16, 200, 768, 12, pack_bias(50, 4)),
                                   ("image B64 T50 C768 H12 (trimodal tied)", 64, 50, 768, 12, None),
                                   *TP_ATTENTION_CASES(torch)):
        qkv, do, cb = rn(B, T, 3 * C), rn(B, T, C), fused_attn.canon_bias(bias)
        _, stats = kernels.attention_fwd(qkv, cb, H, 0.125, stats=True)
        bwd = lambda: kernels.attention_bwd(qkv, do, cb, H, 0.125, stats)
        compare(torch, results, "attention_bwd", case, bwd,
                lambda: kernels.attention_bwd_plain(qkv, do, cb, H, 0.125), reads=(qkv, do, cb, stats),
                ops=attn_ops(B, T, H, products=5), library=_sdpa_bwd(torch, qkv, cb, H, 0.125, do), iters=10)
        if not all(torch.equal(a, b) for a, b in zip(bwd(), bwd())):
            raise AssertionError(f"attention_bwd {case}: two runs differ")
    backward_p_is_forward_p(torch)

    for case, B, T, C in (("audio B4 T306 C768 E3072", BATCH, 306, 768),
                          ("text B1 T308 C512 E2048", 1, 308, 512),
                          ("audio B64 T306 C768 E3072 (train step)", 64, 306, 768)):
        cmp = lambda *a, **k: compare(torch, results, *a, iters=5 if B > BATCH else 10, **k)
        E, M = 4 * C, B * T
        x, gy = rn(B, T, C), rn(B, T, C)
        lns, lnb = 1 + rn(C, std=0.1, dtype=torch.float32), rn(C, std=0.1, dtype=torch.float32)
        wfc, bfc = rn(E, C, std=C ** -0.5), rn(E, std=0.02, dtype=torch.float32)
        wproj, bproj = rn(C, E, std=E ** -0.5), rn(C, std=0.02, dtype=torch.float32)
        h = kernels.layernorm_plain(x, lns, lnb)
        bfc_b = bfc.bfloat16()
        for act in ("quick_gelu", "gelu"):
            c = f"{case} {act}"
            ga, a = kernels.gemm_bias_act_plain(h, wfc, bfc, act, preact=True)
            da = kernels.gemm_dgrad_plain(gy, wproj, True, act, a)
            dh = kernels.gemm_dgrad_plain(da, wfc, False)
            cmp("gemm_bias_act", c + " fc recompute, fp32 preact",
                lambda: kernels.gemm_bias_act(h, wfc, bfc, act, preact=True),
                lambda: kernels.gemm_bias_act_plain(h, wfc, bfc, act, preact=True),
                reads=(h, wfc, bfc), ops=gemm_ops(M, E, C),
                library=lambda: torch.nn.functional.linear(h, wfc, bfc_b))
            wgrad(cmp, c + " dWproj", gy, ga)
            wgrad(cmp, c + " dWfc", da, h)
            cmp("layernorm_bwd", c, lambda: kernels.layernorm_bwd(x, lns, dh, residual=gy),
                lambda: kernels.layernorm_bwd_plain(x, lns, dh, residual=gy), reads=(x, lns, dh, gy),
                ops=[(20 * M * C, "fp32")], library=_layer_norm_bwd(torch, x, lns, dh))
            del ga, a, da, dh
            args = (x, lns, lnb, wfc.float(), bfc, wproj.float(), bproj)  # fp32 params, as trained
            cmp("fused_ln_mlp_block_bwd", c,
                _block_bwd(torch, fused_mlp.fused_ln_mlp_block, args, gy, act=act),
                _block_bwd(torch, fused_mlp.fused_ln_mlp_block_plain, args, gy, act=act),
                reads=(*args, gy), ops=gemm_ops(M, E, C) * 5)
            torch.cuda.empty_cache()

    # the captioning step's decoder: M = 64 x 77 rows at width 512, its four weight grads
    cmp = lambda *a, **k: compare(torch, results, *a, iters=10, **k)
    C = 512
    for name, N1, N2 in (("dWout", C, C), ("dWqkv", 3 * C, C), ("dWproj", C, 4 * C), ("dWfc", 4 * C, C)):
        wgrad(cmp, f"caption decoder B64 T77 C512 {name}", rn(64, 77, N1), rn(64, 77, N2))
    # the AT step's audio tower: M = 50 x 306 rows at width 768, and the trimodal step's tied image
    # tower: M = 64 x 50; their four weight grads
    C = 768
    for tower, B, T in (("audio B50 T306", LA_B, 306), ("image B64 T50", 64, 50)):
        for name, N1, N2 in (("dWout", C, C), ("dWqkv", 3 * C, C), ("dWproj", C, 4 * C), ("dWfc", 4 * C, C)):
            wgrad(cmp, f"{tower} C768 {name}", rn(B, T, N1), rn(B, T, N2))
            torch.cuda.empty_cache()

    # mp_phase's trained audio tower on a model axis of 2: each rank's four weight grads
    for name, N1, N2 in (("dWout", 768, 384), ("dWqkv", 1152, 768), ("dWproj", 768, 1536),
                         ("dWfc", 1536, 768)):
        wgrad(cmp, f"audio B16 T306 tp2 {name}", rn(16, 306, N1), rn(16, 306, N2))

    # gemm_dgrad alone at every shape the paths give it, bitwise equal over two runs
    for case, M, N, K, act, rounded in GEMM_DGRAD_CASES:
        dy, w = rn(M, K), rn(K, N, std=K ** -0.5)
        a = None if act == "none" else rn(M, N, dtype=torch.float32)
        compare(torch, results, "gemm_dgrad", f"{case} [{M}x{N}x{K}]",
                lambda: kernels.gemm_dgrad(dy, w, rounded, act, a),
                lambda: kernels.gemm_dgrad_plain(dy, w, rounded, act, a), reads=(dy, w, a),
                ops=gemm_ops(M, N, K), library=lambda: torch.matmul(dy, w), iters=5 if M > 5000 else 10)
        if not torch.equal(kernels.gemm_dgrad(dy, w, rounded, act, a), kernels.gemm_dgrad(dy, w, rounded, act, a)):
            raise AssertionError(f"gemm_dgrad {case}: two runs differ")
        del dy, w, a
        torch.cuda.empty_cache()


def record_launches(results, path, counts):
    """Each kernel's launch count on one main path (``serve`` or ``train``),
    read right after that path ran from counts set to 0 just before it."""
    for name, n in counts.items():
        results.setdefault(name, {"max_abs_err": 0.0, "cases": [], "launches": {}})["launches"][path] = n


def _engine(torch, batch_size, quantize=""):
    from vipant_tpu_torch.serve import InferenceEngine

    t0 = time.perf_counter()
    eng = InferenceEngine(CLAP_FULL, batch_size=batch_size, seed=0, quantize=quantize)  # on the card
    torch.cuda.synchronize()
    print(f"engine (batch {batch_size}, quantize={quantize!r}) built in "
          f"{time.perf_counter() - t0:.2f} s (seeded random weights)")
    return eng


def _serve_blocks(eng, n_audio=6, n_zero_shot=3):
    """(sub-block calls of each kind, audio tower calls) on the serving path
    below: layers times chunks, for the audio and the text tower; one patch
    gather an audio chunk."""
    nchunks = lambda n: -(-n // eng.batch_size)
    n_prompts = sum(len(v) for v in CLASSES.values())
    audio_chunks = nchunks(n_audio) + nchunks(n_zero_shot)
    text_chunks = nchunks(len(PROMPTS)) + nchunks(n_prompts)
    return (len(eng.model.audio.encoder.resblocks) * audio_chunks
            + len(eng.model.text.encoder.resblocks) * text_chunks), audio_chunks


def _check_embeddings(eng, a, t, zs):
    for name, e, n in (("audio", a, 6), ("text", t, len(PROMPTS))):
        if e.shape != (n, eng._embed_dim()) or not np.isfinite(e).all():
            raise AssertionError(f"{name} embeddings: shape {e.shape}, finite {np.isfinite(e).all()}")
        norms = np.linalg.norm(e, axis=-1)
        if np.abs(norms - 1).max() > 1e-2:
            raise AssertionError(f"{name} embeddings are not unit-norm: {norms}")
    if zs["scores"].shape != (3, len(CLASSES)) or not np.allclose(zs["probs"].sum(1), 1, atol=1e-5):
        raise AssertionError(f"zero_shot output malformed: {zs}")
    print(f"zero_shot predictions: {zs['prediction']}")


def _timed_ms(torch, fn, reps=10):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _row_cos(e, r):
    return (e * r).sum(-1) / (np.linalg.norm(e, axis=-1) * np.linalg.norm(r, axis=-1))


def slice_phase(torch, results):
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches

    eng = _engine(torch, BATCH)
    fb = np.random.default_rng(0).standard_normal((6, 1000, 128)).astype(np.float32)

    # the serving path: its launches are counted from here
    reset_launches()
    a = eng.embed_audio(fb)
    t = eng.embed_texts(PROMPTS)
    zs = eng.zero_shot(fb[:3], CLASSES)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"launches on the serving path: {json.dumps(counts, sort_keys=True)}")

    blocks, audio_chunks = _serve_blocks(eng)
    want = {
        "fused_ln_attention_block": blocks,
        "fused_ln_mlp_block": blocks,
        "layernorm_fwd": 2 * blocks,
        "gemm_bias_act": 4 * blocks,
        "attention_fwd": blocks,
        "patch_gather": audio_chunks,
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    record_launches(results, "serve", counts)
    _check_embeddings(eng, a, t, zs)

    timed = lambda fn: _timed_ms(torch, fn)
    ms = {"audio": timed(lambda: eng.embed_audio(fb[:BATCH])),
          "text": timed(lambda: eng.embed_texts(PROMPTS[:BATCH]))}

    # the same engine on the plain ops, on the card
    with plain_ops():
        a_ref, t_ref = eng.embed_audio(fb), eng.embed_texts(PROMPTS)
        plain_ms = {"audio": timed(lambda: eng.embed_audio(fb[:BATCH])),
                    "text": timed(lambda: eng.embed_texts(PROMPTS[:BATCH]))}
    for name, e, r in (("audio", a, a_ref), ("text", t, t_ref)):
        cos = _row_cos(e, r)
        print(f"{name} embedding cosine vs plain ops on the card: min {cos.min():.6f}")
        if cos.min() < COS_MIN:
            raise AssertionError(f"{name} cosine {cos.min()} < {COS_MIN}")
    for k in ms:
        print(f"{k}: {ms[k]:.3f} ms per batch of {BATCH} (kernels), "
              f"{plain_ms[k]:.3f} ms (plain ops)")


def int8_kernel_phase(torch, results):
    """Every int8 kernel on the inputs its chain gives it, and both int8
    sub-blocks, against the plain versions; each sub-block also beside the
    bf16 kernel chain of the same sub-block."""
    from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels

    rn = _seeded(torch)
    pack_bias, text_bias = _biases(torch)
    f32 = torch.float32
    quant_ops = lambda t: [(4 * t.numel(), "fp32")]

    def codes(x):
        """rowquant: within check_codes of the plain version, then bitwise it
        (the same IEEE division, rounding and clip) and the same bits in a
        second run."""
        def check(_, got, want, what):
            err, desc = check_codes(torch, got, want, what)
            again = kernels.rowquant(x)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{what}: {desc}, not bitwise the plain version")
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{what}: two runs differ")
            return err, "codes and scales bitwise plain, and across two runs"
        return check

    def ln_codes(x, lns, lnb):
        """layernorm_rowquant: bitwise the chain layernorm_fwd -> rowquant (the
        LayerNorm code is shared). Against the plain LayerNorm (whose
        statistics are the kernels', both in float64) a normalised value
        that rounded to the neighbouring bf16 would move its code by one,
        and where it is the row's largest, the scale by a bf16 ulp."""
        def check(_, got, want, what):
            q, s = kernels.rowquant(kernels.layernorm_fwd(x, lns, lnb))
            if not (torch.equal(got[0], q) and torch.equal(got[1], s)):
                raise AssertionError(f"{what}: differs from layernorm_fwd -> rowquant")
            q, s = kernels.layernorm_rowquant(x, lns, lnb)
            if not (torch.equal(got[0], q) and torch.equal(got[1], s)):
                raise AssertionError(f"{what}: two runs differ")
            d = (got[0].int() - want[0].int()).abs()
            off, share = d.max().item(), (d != 0).float().mean().item()
            if off > 1 or share > 1e-2 or not torch.allclose(got[1], want[1], rtol=2 ** -7, atol=0):
                raise AssertionError(f"{what}: codes off by up to {off} (share {share:.2e}) or scales "
                                     f"beyond one bf16 ulp of the plain LayerNorm's")
            err = (got[0].float() * got[1] - want[0].float() * want[1]).abs().max().item()
            return err, (f"= layernorm_fwd->rowquant bitwise, and across two runs; vs plain LN {share:.1e} "
                         f"codes off by one")
        return check

    def int_mm(xq, wq):
        x2 = xq.reshape(-1, xq.shape[-1])
        return lambda: torch._int_mm(x2, wq.t())

    # layernorm_rowquant at every (rows, C) of LAYERNORM_CASES (one all-zero token): its statistics
    # are layernorm_fwd's, so it is held bitwise to the chain at every width and row count
    for case, M, C in LAYERNORM_CASES:
        x = rn(M, C)
        x[min(1, M - 1)] = 0
        lns, lnb = 1 + rn(C, std=0.1, dtype=f32), rn(C, std=0.1, dtype=f32)
        compare(torch, results, "layernorm_rowquant", f"{case} [{M}x{C}]",
                lambda: kernels.layernorm_rowquant(x, lns, lnb),
                lambda: kernels.layernorm_rowquant_plain(x, lns, lnb), reads=(x, lns, lnb),
                ops=[(12 * M * C, "fp32")], check=ln_codes(x, lns, lnb), iters=5 if M > 5000 else 10,
                device=True)

    # rowquant at every (rows, K, dtype) of ROWQUANT_CASES (one all-zero row), bitwise its plain
    # version and across two runs
    for case, M, K, dtype in ROWQUANT_CASES:
        x = rn(M, K, std=3.0, dtype=f32 if dtype == "fp32" else torch.bfloat16)
        x[1] = 0
        compare(torch, results, "rowquant", f"{case} [{M}x{K} {dtype}]", lambda: kernels.rowquant(x),
                lambda: kernels.rowquant_plain(x), reads=(x,), ops=quant_ops(x), check=codes(x),
                iters=5 if M * K > 2 ** 24 else 10, device=True)
        del x

    attn_cases = [  # audio, packed text, packed image; serving and batch shapes
        ("audio B4 T306 C768 H12", BATCH, 306, 768, 12, None),
        ("audio B64 T306 C768 H12", 64, 306, 768, 12, None),
        ("text B1 T308 C512 H8 causal+pack", 1, 308, 512, 8, text_bias),
        ("text B16 T308 C512 H8 causal+pack", 16, 308, 512, 8, text_bias),
        ("image B16 T200 C768 H12 pack", 16, 200, 768, 12, pack_bias(50, 4)),
    ]
    for case, B, T, C, H, bias in attn_cases:
        cmp = lambda *a, **k: compare(torch, results, *a, iters=5 if B > BATCH else 10, **k)
        M = B * T
        x = rn(B, T, C)
        x[0, 1] = 0  # an all-zero token
        lns, lnb = 1 + rn(C, std=0.1, dtype=f32), rn(C, std=0.1, dtype=f32)
        wqkv, bqkv = rn(3 * C, C, std=C ** -0.5, dtype=f32), rn(3 * C, std=0.02, dtype=f32)
        wout, bout = rn(C, C, std=C ** -0.5, dtype=f32), rn(C, std=0.02, dtype=f32)
        cb = fused_attn.canon_bias(bias)
        wq_b = wqkv.bfloat16()
        wq8, swq = kernels.rowquant_plain(wq_b)
        h8, sh = kernels.layernorm_rowquant_plain(x, lns, lnb)
        qkv = kernels.gemm_i8_plain(h8, sh, wq8, swq, bqkv, col_first=True)
        o = kernels.attention_plain(qkv, cb, H, 0.125, fp32_out=True)
        args = (x, lns, lnb, wqkv, bqkv, wout, bout, bias, H)
        cmp("rowquant", case + " Wqkv bf16", lambda: kernels.rowquant(wq_b),
            lambda: kernels.rowquant_plain(wq_b), reads=(wq_b,), ops=quant_ops(wq_b), check=codes(wq_b))
        cmp("attention_fwd_f32", case, lambda: kernels.attention_fwd(qkv, cb, H, 0.125, fp32_out=True),
            lambda: kernels.attention_plain(qkv, cb, H, 0.125, fp32_out=True), reads=(qkv, cb),
            ops=attn_ops(B, T, H), library=_sdpa(torch, qkv, cb, H, 0.125))
        cmp("rowquant", case + " context fp32", lambda: kernels.rowquant(o),
            lambda: kernels.rowquant_plain(o), reads=(o,), ops=quant_ops(o), check=codes(o))
        del qkv, o, h8
        cmp("fused_ln_attention_block_int8", case,
            lambda: fused_attn.fused_ln_attention_block_int8(*args),
            lambda: fused_attn.fused_ln_attention_block_int8_plain(*args), reads=args[:8],
            ops=gemm_ops(M, 3 * C, C, "int8") + attn_ops(B, T, H) + gemm_ops(M, C, C, "int8"),
            also={"bf16_chain_ms": lambda: fused_attn.fused_ln_attention_block(*args)})
        torch.cuda.empty_cache()

    for case, B, T, C in (("audio B4 T306 C768 E3072", BATCH, 306, 768),
                          ("audio B64 T306 C768 E3072", 64, 306, 768),
                          ("text B1 T308 C512 E2048", 1, 308, 512),
                          ("text B16 T308 C512 E2048", 16, 308, 512),
                          ("image B16 T200 C768 E3072", 16, 200, 768)):
        cmp = lambda *a, **k: compare(torch, results, *a, iters=5 if B > BATCH else 10, **k)
        E, M = 4 * C, B * T
        x = rn(B, T, C)
        x[0, 1] = 0
        lns, lnb = 1 + rn(C, std=0.1, dtype=f32), rn(C, std=0.1, dtype=f32)
        wfc, bfc = rn(E, C, std=C ** -0.5, dtype=f32), rn(E, std=0.02, dtype=f32)
        wproj, bproj = rn(C, E, std=E ** -0.5, dtype=f32), rn(C, std=0.02, dtype=f32)
        wf8, sfc = kernels.rowquant_plain(wfc)
        h8, hs = kernels.layernorm_rowquant_plain(x, lns, lnb)
        cmp("rowquant", case + " Wfc fp32", lambda: kernels.rowquant(wfc),
            lambda: kernels.rowquant_plain(wfc), reads=(wfc,), ops=quant_ops(wfc), check=codes(wfc))
        for act in ("quick_gelu", "gelu"):
            c = f"{case} {act}"
            g = kernels.gemm_i8_plain(h8, hs, wf8, sfc, bfc, act=act, out_dtype=f32)
            args = (x, lns, lnb, wfc, bfc, wproj, bproj, act)
            cmp("rowquant", c + " act(a) fp32", lambda: kernels.rowquant(g),
                lambda: kernels.rowquant_plain(g), reads=(g,), ops=quant_ops(g), check=codes(g))
            del g
            cmp("fused_ln_mlp_block_int8", c, lambda: fused_mlp.fused_ln_mlp_block_int8(*args),
                lambda: fused_mlp.fused_ln_mlp_block_int8_plain(*args), reads=args[:7],
                ops=gemm_ops(M, E, C, "int8") + gemm_ops(M, C, E, "int8"),
                also={"bf16_chain_ms": lambda: fused_mlp.fused_ln_mlp_block(*args)})
            torch.cuda.empty_cache()

    # gemm_i8 alone at every shape the paths give it (one all-zero row, one row of codes at +127
    # against a column at -127: the largest sum there is), bitwise equal over two runs, and its
    # integer sum bitwise the exact one at unit scales
    for case, M, N, K, act, res, out_f32, col_first in GEMM_I8_CASES:
        x = rn(M, K)
        x[1] = 0
        xq, rs = kernels.rowquant_plain(x)
        wq, cs = kernels.rowquant_plain(rn(N, K, std=K ** -0.5))
        xq[2], wq[0] = 127, -127
        b, r = rn(N, std=0.02, dtype=f32), (rn(M, N) if res else None)
        kw = dict(act=act, residual=r, out_dtype=f32 if out_f32 else torch.bfloat16, col_first=col_first)
        run = lambda: kernels.gemm_i8(xq, rs, wq, cs, b, **kw)
        compare(torch, results, "gemm_i8", f"{case} [{M}x{N}x{K}]", run,
                lambda: kernels.gemm_i8_plain(xq, rs, wq, cs, b, **kw), reads=(xq, rs, wq, cs, b, r),
                ops=gemm_ops(M, N, K, "int8"), library=int_mm(xq, wq), iters=5 if M > 5000 else 10)
        if not torch.equal(run(), run()):
            raise AssertionError(f"gemm_i8 {case}: two runs differ")
        ones = lambda n: torch.ones(n, 1, device="cuda")
        exact = kernels.gemm_i8(xq, ones(M), wq, ones(N), torch.zeros(N, device="cuda"), out_dtype=f32)
        if not torch.equal(exact, kernels.int_matmul_plain(xq, wq)):
            raise AssertionError(f"gemm_i8 {case}: the integer sum at unit scales is not the exact one")
        del x, xq, wq, r, exact
        torch.cuda.empty_cache()
    print("  gemm_i8: the integer sum at unit scales bitwise the exact one at every case")


def int8_serve_phase(torch, results):
    """The full CLAP engine with ``quantize="int8"`` beside the bf16 engine
    of the same seed."""
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches

    eng8, eng = _engine(torch, BATCH, "int8"), _engine(torch, BATCH)
    fb = np.random.default_rng(0).standard_normal((6, 1000, 128)).astype(np.float32)

    # the int8 serving path: its launches are counted from here
    reset_launches()
    a = eng8.embed_audio(fb)
    t = eng8.embed_texts(PROMPTS)
    zs = eng8.zero_shot(fb[:3], CLASSES)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"launches on the int8 serving path: {json.dumps(counts, sort_keys=True)}")
    blocks, audio_chunks = _serve_blocks(eng8)
    want = {  # every sub-block call of both towers on the int8 chain, none on the bf16 one
        "fused_ln_attention_block_int8": blocks, "fused_ln_mlp_block_int8": blocks,
        "rowquant": 6 * blocks, "layernorm_rowquant": 2 * blocks, "gemm_i8": 4 * blocks,
        "attention_fwd_f32": blocks, "patch_gather": audio_chunks,
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    record_launches(results, "serve_int8", counts)
    _check_embeddings(eng8, a, t, zs)

    with plain_ops():  # the same int8 engine on the plain ops, on the card
        a_plain, t_plain = eng8.embed_audio(fb), eng8.embed_texts(PROMPTS)
    a_bf16, t_bf16 = eng.embed_audio(fb), eng.embed_texts(PROMPTS)
    zs_bf16 = eng.zero_shot(fb[:3], CLASSES)
    for name, e, pl, ref in (("audio", a, a_plain, a_bf16), ("text", t, t_plain, t_bf16)):
        kp, kb, pb = _row_cos(e, pl).min(), _row_cos(e, ref).min(), _row_cos(pl, ref).min()
        print(f"{name} int8 embedding cosine: kernels vs plain int8 ops {kp:.6f}; vs the bf16 kernel "
              f"engine: kernels {kb:.6f}, plain int8 ops {pb:.6f}")
        if kp < COS_MIN:
            raise AssertionError(f"{name}: int8 kernels vs plain int8 ops cosine {kp} < {COS_MIN}")
        if kb < INT8_COS_MIN and kb < pb - COS_SLACK:
            raise AssertionError(f"{name}: int8 kernels are further from bf16 ({kb}) than the bar "
                                 f"{INT8_COS_MIN} and than the plain int8 path ({pb})")
    if zs["prediction"] == zs_bf16["prediction"]:
        print(f"zero_shot: int8 picks the bf16 engine's classes {zs_bf16['prediction']}")
    else:
        print(f"zero_shot: int8 picks {zs['prediction']}, bf16 {zs_bf16['prediction']}; scores int8 "
              f"{np.round(zs['scores'], 4).tolist()} bf16 {np.round(zs_bf16['scores'], 4).tolist()}")

    def ms_per_batch(e8, e, B):
        fbb = np.random.default_rng(1).standard_normal((B, 1000, 128)).astype(np.float32)
        texts = [PROMPTS[i % len(PROMPTS)] for i in range(B)]
        for name, fn in (("embed_audio", lambda en: en.embed_audio(fbb)),
                         ("embed_texts", lambda en: en.embed_texts(texts))):
            tb1, t81 = _timed_ms(torch, lambda: fn(e), 5), _timed_ms(torch, lambda: fn(e8), 5)
            t82, tb2 = _timed_ms(torch, lambda: fn(e8), 5), _timed_ms(torch, lambda: fn(e), 5)
            print(f"{name}: {(t81 + t82) / 2:.3f} ms per batch of {B} (int8), "
                  f"{(tb1 + tb2) / 2:.3f} ms (bf16)")
        if B > BATCH:  # where the device time of an audio batch goes, int8 beside bf16
            for label, en in (("int8", e8), ("bf16", e)):
                busy, span, by_name = _profile(torch, lambda: en.embed_audio(fbb))
                top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
                print(f"profiler, embed_audio batch {B} {label}: device busy {busy:.2f} ms / span "
                      f"{span:.2f} ms per batch; top kernels by device time per batch: "
                      + "; ".join(f"{d / 3:.3f} ms {n / 3:.1f}x {k[:60]}" for k, (n, d) in top))

    ms_per_batch(eng8, eng, BATCH)
    del eng8, eng
    torch.cuda.empty_cache()
    ms_per_batch(_engine(torch, 64, "int8"), _engine(torch, 64), 64)


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _cos(torch, a, b):
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    return 1.0 if na == nb == 0 else (a @ b).item() / max(na * nb, 1e-300)


def _va_batch(tr, rng, B):
    return tr.make_batch(rng.standard_normal((B, 3, 224, 224)).astype(np.float32),
                         rng.standard_normal((B, 1, 1000, 128)).astype(np.float32))


def _trainer(torch, B, *extra):
    from vipant_tpu_torch.train import Trainer

    torch.cuda.empty_cache()
    return Trainer(FLAGSHIP + [f"running.batch_size={B}", *extra],  # on the card, the default
                   steps_per_epoch=STEPS_PER_EPOCH)


def _profile(torch, fn, steps=3):
    """Device time per call over ``steps`` calls from a ``torch.profiler``
    trace: busy time (kernel, copy and fill intervals merged on the
    timeline), the span from the first device event to the last, and device
    time and launches by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type.name != "CUDA" or getattr(e, "is_user_annotation", False):
            continue  # host events, and annotations that only mark a range on the card
        s, t = e.time_range.start, e.time_range.end
        if t <= s:
            continue
        spans.append((s, t))
        n, d = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, d + (t - s) / 1e3)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    spans.sort()
    busy, cur_s, cur_t = 0.0, spans[0][0], spans[0][1]
    for s, t in spans[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    span = spans[-1][1] - spans[0][0]
    return busy / 1e3 / steps, span / 1e3 / steps, by_name


def hold_grads_to_fp32(torch, label, what, kernels, plain, fp32):
    """One step's (loss, grads) on the kernels (K), on the plain ops in bf16
    (P) and on the plain ops in fp32 (F), from the same init and batch: the
    loss and the grad norm of K within 1e-2 of P's, and per grad K no further
    from F than P is (the module docstring's phase 6 (i) states the slack).
    The loss heads' ``logit_scale`` is printed and left out of the last two."""
    from vipant_tpu_torch.optim import global_norm

    (loss_k, g_k), (loss_p, g_p), (loss_f, g_f) = kernels, plain, fp32
    n_k, n_p = float(global_norm(list(g_k.values()))), float(global_norm(list(g_p.values())))
    loss_k, loss_p, loss_f = float(loss_k), float(loss_p), float(loss_f)
    rows = []  # (cos(K, F) - cos(P, F), cos(K, P), cos(K, F), cos(P, F), name)
    scale = []  # (rel err(K) - rel err(P), |s(K) - s(P)|, rel err(K), rel err(P), name, s(K), s(P))
    for k in g_k:
        if not bool(torch.isfinite(g_k[k]).all()):
            raise AssertionError(f"grad {k} is not finite")
        kp, kf, pf = (_cos(torch, a, b) for a, b in ((g_k[k], g_p[k]), (g_k[k], g_f[k]),
                                                      (g_p[k], g_f[k])))
        rows.append((kf - pf, kp, kf, pf, k))
        K, P, F = (g[k].double().flatten() for g in (g_k, g_p, g_f))
        if not bool(F.any()):  # a param the loss does not reach: zero on every path
            if bool(K.any()) or bool(P.any()):
                raise AssertionError(f"grad {k} is zero in fp32 and not on the bf16 paths")
            continue
        nf = F.norm().item()
        ek, ep = (K - F).norm().item() / nf, (P - F).norm().item() / nf
        sk, sp = (K @ F).item() / nf ** 2, (P @ F).item() / nf ** 2
        row = (ek - ep, abs(sk - sp), ek, ep, k, sk, sp)
        if k.startswith(("loss.", "lm_loss.")):  # the loss head's grads come before any backward kernel
            print(f"    {k} (forward features only): |K-F|/|F| {ek:.6f} |P-F|/|F| {ep:.6f} "
                  f"s(K) {sk:.6f} s(P) {sp:.6f}")
        else:
            scale.append(row)
    flat = {n: torch.cat([g[k].flatten() for k in g_k]) for n, g in (("K", g_k), ("P", g_p), ("F", g_f))}
    whole = {n: _cos(torch, flat[a], flat[b]) for n, (a, b) in
             (("K,P", ("K", "P")), ("K,F", ("K", "F")), ("P,F", ("P", "F")))}
    print(f"{label} loss kernels {loss_k:.6f} plain {loss_p:.6f} fp32 {loss_f:.6f}; grad_norm "
          f"kernels {n_k:.6f} plain {n_p:.6f}; whole-grad cosine "
          + ", ".join(f"{n} {v:.6f}" for n, v in whole.items()))
    print(f"    per grad ({len(rows)}): min cos(K,P) {min(r[1] for r in rows):.6f}, "
          f"min cos(K,F) {min(r[2] for r in rows):.6f}, min cos(P,F) {min(r[3] for r in rows):.6f}")
    for r in sorted(rows)[:3]:
        print(f"    largest shortfall of the kernels against fp32: {r[4]}: cos(K,F) {r[2]:.6f} "
              f"cos(P,F) {r[3]:.6f} cos(K,P) {r[1]:.6f}")
    for r in sorted(scale, reverse=True)[:3]:
        print(f"    largest excess of the kernels' relative error to fp32: {r[4]}: |K-F|/|F| "
              f"{r[2]:.6f} |P-F|/|F| {r[3]:.6f}")
    gaps = sorted(scale, key=lambda r: -r[1])
    worst = gaps[0]
    print(f"    max relative error to fp32: kernels {max(r[2] for r in scale):.6f}, plain "
          f"{max(r[3] for r in scale):.6f}; scale along fp32 s-1: mean kernels "
          f"{np.mean([r[5] for r in scale]) - 1:+.6f}, plain {np.mean([r[6] for r in scale]) - 1:+.6f}; "
          f"largest |s(K)-s(P)| " + ", ".join(f"{r[1]:.6f} ({r[4]})" for r in gaps[:3]))
    if not (np.isfinite(loss_k) and abs(loss_k - loss_p) <= REL * abs(loss_p)
            and abs(n_k - n_p) <= REL * n_p and min(rows)[0] >= -COS_SLACK
            and whole["K,F"] >= whole["P,F"] - COS_SLACK / 5
            and max(scale)[0] <= ERR_SLACK and worst[1] <= SCALE_SLACK):
        raise AssertionError(f"the {what} step's loss or grads on the kernels are further from "
                             "the fp32 reference than the plain ops' bf16 grads")


def train_phase(torch, results):
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.train import loss_and_grads

    # (i) one init and batch (B = 16): kernels against the plain ops
    B = 16
    tr = _trainer(torch, B)
    audio_layers, image_layers = len(tr.model.audio.encoder.resblocks), len(tr.model.image.encoder.resblocks)
    T_audio = tr.model.audio.grid[0] * tr.model.audio.grid[1] + 1
    print(f"VA step: audio tower T={T_audio}, {audio_layers} layers trainable; image tower "
          f"{image_layers} layers frozen, token_pack={tr.model.image.token_pack}; "
          f"{sum(p.numel() for p in tr.trainable.values()):,} trainable / "
          f"{sum(p.numel() for p in tr.frozen.values()):,} frozen params")
    batch = _va_batch(tr, np.random.default_rng(0), B)
    loss_k, g_k = loss_and_grads(tr.state, *batch)
    with plain_ops():
        loss_p, g_p = loss_and_grads(tr.state, *batch)
        ref = _trainer(torch, B, "compute_dtype=float32")  # same seed: same init
        loss_f, g_f = loss_and_grads(ref.state, *batch)
    del ref
    hold_grads_to_fp32(torch, f"(i) B={B}", "VA", (loss_k, g_k), (loss_p, g_p), (loss_f, g_f))

    # (ii) the training path: its launches are counted from here, one step
    init = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    reset_launches()
    losses = [float(tr.train_step(*batch)["loss"])]
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"(ii) launches in one training step: {json.dumps(counts, sort_keys=True)}")
    fwd_blocks, bwd_blocks = audio_layers + image_layers, audio_layers
    want = {
        "fused_ln_attention_block": fwd_blocks, "fused_ln_mlp_block": fwd_blocks,
        "fused_ln_attention_block_bwd": bwd_blocks, "fused_ln_mlp_block_bwd": bwd_blocks,
        "layernorm_fwd": 2 * fwd_blocks + 2 * bwd_blocks, "gemm_bias_act": 4 * fwd_blocks + bwd_blocks,
        "attention_fwd": fwd_blocks, "attention_bwd": bwd_blocks, "layernorm_bwd": 2 * bwd_blocks,
        "colsum": 4 * bwd_blocks, "gemm_dgrad": 4 * bwd_blocks, "gemm_wgrad": 4 * bwd_blocks,
        "patch_gather": 2,  # one a tower
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    record_launches(results, "train", counts)

    # (iii) five LARS steps at production knobs
    for i in range(4):
        losses.append(float(tr.train_step(*batch)["loss"]))
        if i == 0:
            moved = [k for k, p in tr.trainable.items() if not torch.equal(p.detach(), init[k])]
    step = max((p.detach() - init[k]).abs().max().item() for k, p in tr.trainable.items())
    print(f"(iii) LARS losses {[round(v, 5) for v in losses]}; lr at step 4 "
          f"{tr.state.optimizer.schedule(4):.3e}; {len(moved)} of {len(tr.trainable)} "
          f"trainable params moved by step 2; largest change of a param after 5 steps {step:.3e}")
    if not np.isfinite(losses).all() or not any(k.startswith("audio.") for k in moved):
        raise AssertionError("LARS steps: non-finite loss or the audio tower did not move")
    for k, p in tr.frozen.items():
        if not torch.equal(p.detach(), init[k]) or p.grad is not None:
            raise AssertionError(f"frozen image param {k} changed")
    del tr, batch, g_k, g_p, init

    # (iv) time at B = 64, kernels against plain ops
    B = 64
    tr = _trainer(torch, B)
    batch = _va_batch(tr, np.random.default_rng(1), B)

    def fwd():
        with torch.no_grad():
            return tr.model(*batch, train=True)

    timing = {}
    for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_ops)):
        with ctx():
            timing[label] = {"fwd": cuda_ms(torch, fwd, 5, 2),
                             "fwd_bwd": cuda_ms(torch, lambda: loss_and_grads(tr.state, *batch), 5, 2),
                             "step": cuda_ms(torch, lambda: tr.train_step(*batch), 5, 2)}
    results["_va_step_ms"] = timing["kernels"]["step"]  # phase 14 prints it beside the loop's
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(*batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for label, t in timing.items():
        print(f"(iv) B={B} {label}: {t['step']:.2f} ms/step ({B / t['step'] * 1e3:.1f} clips/s): "
              f"fwd {t['fwd']:.2f}, fwd+bwd {t['fwd_bwd']:.2f}, "
              f"optimizer and the rest {t['step'] - t['fwd_bwd']:.2f} ms")
    print(f"(iv) peak device memory of a kernel step at B={B}: {peak:.2f} GiB")
    busy, span, by_name = _profile(torch, lambda: tr.train_step(*batch))
    step_ms = timing["kernels"]["step"]
    print(f"(iv) profiler, kernel step at B={B}: device busy {busy:.2f} ms / span {span:.2f} ms "
          f"per step (idle {100 * (1 - busy / span):.1f} % of the traced span, "
          f"{100 * max(0.0, 1 - busy / step_ms):.1f} % of the untraced {step_ms:.2f} ms step); "
          f"top kernels by device time per step:")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"    {d / 3:9.3f} ms  {n // 3:5d}x  {name[:90]}")
    del tr, batch

    # (v) Adam descent smoke, and its first losses on the plain ops
    B, n_steps = 32, 60
    adam = ["optimizer.use_lars=False", "optimizer.warmup=False", "optimizer.lr=1.0e-3"]
    curves = {}
    for label, ctx, steps in (("kernels", contextlib.nullcontext, n_steps), ("plain", plain_ops, 10)):
        tr = _trainer(torch, B, *adam)
        batches = [_va_batch(tr, np.random.default_rng(7 + i), B) for i in range(4)]
        with ctx():
            curves[label] = [float(tr.train_step(*batches[i % 4])["loss"]) for i in range(steps)]
        del tr, batches
    k, p = np.asarray(curves["kernels"]), np.asarray(curves["plain"])
    print(f"(v) Adam B={B}: kernels {np.round(k[::5], 4).tolist()} ... last 5 mean "
          f"{k[-5:].mean():.4f}; plain first 10 {np.round(p, 4).tolist()}")
    if not (np.isfinite(k).all() and k[-5:].mean() < 0.9 * k[0]):
        raise AssertionError(f"Adam smoke did not descend: {k.tolist()}")
    if (np.abs(k[:10] - p) > 0.02 * np.abs(p)).any():
        raise AssertionError(f"first 10 Adam losses: kernels {k[:10]} vs plain {p}")


def train_int8_phase(torch, results):
    """The VA step with ``model.image.int8_frozen=True``: the frozen image
    tower on the int8 kernels, the trainable audio tower on the bf16 ones."""
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.optim import global_norm
    from vipant_tpu_torch.train import loss_and_grads

    INT8 = "model.image.int8_frozen=True"

    # (i) B = 16, beside the bf16 frozen tower from the same init and batch
    B = 16
    tr8, tr = _trainer(torch, B, INT8), _trainer(torch, B)
    audio_layers, image_layers = len(tr8.model.audio.encoder.resblocks), len(tr8.model.image.encoder.resblocks)
    batch = _va_batch(tr8, np.random.default_rng(0), B)
    with torch.no_grad():
        v8, v = tr8.model.encode_image(batch[0]), tr.model.encode_image(batch[0])
        with plain_ops():
            v8_plain = tr8.model.encode_image(batch[0])
    cos = lambda a, b: torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min().item()
    kp, kb, pb = cos(v8, v8_plain), cos(v8, v), cos(v8_plain, v)
    (loss8, g8), (loss, g) = loss_and_grads(tr8.state, *batch), loss_and_grads(tr.state, *batch)
    n8, n = float(global_norm(list(g8.values()))), float(global_norm(list(g.values())))
    print(f"(i) B={B} image features, int8 frozen tower: cosine vs plain int8 ops {kp:.6f}; vs the bf16 "
          f"frozen tower: kernels {kb:.6f}, plain int8 ops {pb:.6f}; loss int8_frozen {float(loss8):.6f} "
          f"bf16 {float(loss):.6f}; grad_norm int8_frozen {n8:.6f} bf16 {n:.6f}")
    if kp < COS_MIN or (kb < INT8_COS_MIN and kb < pb - COS_SLACK):
        raise AssertionError("the int8 frozen tower's features are off its plain version or the bf16 tower")
    if not (np.isfinite(float(loss8)) and np.isfinite(n8) and abs(float(loss8) - float(loss)) <= 0.05 * abs(float(loss))):
        raise AssertionError(f"int8_frozen loss {float(loss8)} against bf16 {float(loss)}")
    del tr, g8, g, v8, v, v8_plain

    # (ii) the int8_frozen training path: its launches are counted from here, one step
    init = {k: p.detach().clone() for k, p in tr8.model.named_parameters()}
    reset_launches()
    losses = [float(tr8.train_step(*batch)["loss"])]
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"(ii) launches in one int8_frozen training step: {json.dumps(counts, sort_keys=True)}")
    fwd, bwd, q = audio_layers, audio_layers, image_layers
    want = {  # the image tower on the int8 chain only; the audio tower as in the bf16 step
        "fused_ln_attention_block_int8": q, "fused_ln_mlp_block_int8": q, "rowquant": 6 * q,
        "layernorm_rowquant": 2 * q, "gemm_i8": 4 * q, "attention_fwd_f32": q,
        "fused_ln_attention_block": fwd, "fused_ln_mlp_block": fwd,
        "fused_ln_attention_block_bwd": bwd, "fused_ln_mlp_block_bwd": bwd,
        "layernorm_fwd": 2 * fwd + 2 * bwd, "gemm_bias_act": 4 * fwd + bwd,
        "attention_fwd": fwd, "attention_bwd": bwd, "layernorm_bwd": 2 * bwd,
        "colsum": 4 * bwd, "gemm_dgrad": 4 * bwd, "gemm_wgrad": 4 * bwd, "patch_gather": 2,
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    record_launches(results, "train_int8_frozen", counts)

    # (iii) five LARS steps: the image params stay bitwise as they were
    losses += [float(tr8.train_step(*batch)["loss"]) for _ in range(4)]
    moved = sum(not torch.equal(p.detach(), init[k]) for k, p in tr8.trainable.items())
    print(f"(iii) LARS losses under int8_frozen {[round(v, 5) for v in losses]}; {moved} of "
          f"{len(tr8.trainable)} trainable params moved; {len(tr8.frozen)} frozen params checked")
    if not np.isfinite(losses).all() or moved == 0:
        raise AssertionError("int8_frozen LARS steps: non-finite loss or nothing moved")
    for k, p in tr8.frozen.items():
        if not torch.equal(p.detach(), init[k]) or p.grad is not None:
            raise AssertionError(f"frozen image param {k} changed")
    del tr8, batch, init

    # (iv) ms per step at B = 64, beside the bf16 step's (order bf16, int8, int8, bf16)
    B = 64
    tr8, tr = _trainer(torch, B, INT8), _trainer(torch, B)
    batch = _va_batch(tr8, np.random.default_rng(1), B)
    step = lambda t: cuda_ms(torch, lambda: t.train_step(*batch), 5, 2)
    image = lambda t: cuda_ms(torch, lambda: t.model.encode_image(batch[0]), 10, 2)
    b1, i1, i2, b2 = step(tr), step(tr8), step(tr8), step(tr)
    fb1, fi1, fi2, fb2 = image(tr), image(tr8), image(tr8), image(tr)
    fb, fi = (fb1 + fb2) / 2, (fi1 + fi2) / 2
    print(f"(iv) B={B}: {(i1 + i2) / 2:.2f} ms/step with int8_frozen ({B / ((i1 + i2) / 2) * 1e3:.1f} "
          f"clips/s), {(b1 + b2) / 2:.2f} ms/step bf16 ({B / ((b1 + b2) / 2) * 1e3:.1f} clips/s); the "
          f"frozen image tower alone: {fi:.2f} ms int8, {fb:.2f} ms bf16")
    del tr8, tr, batch

    # (v) Adam descent smoke under int8_frozen
    B, n_steps = 32, 60
    tr8 = _trainer(torch, B, INT8, "optimizer.use_lars=False", "optimizer.warmup=False", "optimizer.lr=1.0e-3")
    batches = [_va_batch(tr8, np.random.default_rng(7 + i), B) for i in range(4)]
    k = np.asarray([float(tr8.train_step(*batches[i % 4])["loss"]) for i in range(n_steps)])
    print(f"(v) Adam B={B} under int8_frozen: {np.round(k[::5], 4).tolist()} ... last 5 mean {k[-5:].mean():.4f}")
    if not (np.isfinite(k).all() and k[-5:].mean() < 0.9 * k[0]):
        raise AssertionError(f"Adam smoke under int8_frozen did not descend: {k.tolist()}")


def flash_ops(B, Tq, Tk, H, products=2):
    """``products`` Tq x Tk x 64 products per head: 2 forward and for the
    bias grad (scores, p.v or dp), 5 backward."""
    return [(products * 2 * B * H * Tq * Tk * 64, "bf16")]


def _sdpa4(torch, q, k, v, bias):
    """The library's attention on [B, T, H, D] tensors (views to its
    [B, H, T, D]), its autograd backward for the cotangent ``do``, and that
    backward taken for a float mask alone: the [Tq, Tk] bias grad."""
    F = torch.nn.functional
    mask = None if bias is None else bias.to(q.dtype)
    heads = lambda t: t.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask)

    def bwd(do):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*(heads(t) for t in leaves), attn_mask=mask)
        return lambda: torch.autograd.grad(out, leaves, heads(do), retain_graph=True)

    def dbias(do):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        # the fused backends may refuse a mask that wants a grad at these lengths: then the math backend
        for backend in (None, SDPBackend.MATH):
            leaf = mask.detach().clone().requires_grad_()
            with contextlib.nullcontext() if backend is None else sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=leaf)
            call = lambda: torch.autograd.grad(out, leaf, heads(do), retain_graph=True)
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"  library bias grad, backend {backend or 'default'}: {str(e).splitlines()[0]}")
                continue
            print(f"  library bias grad: scaled_dot_product_attention's backward, backend {backend or 'default'}")
            return call
        return None

    return fwd, bwd, dbias


def flash_kernel_phase(torch, results):
    """The three flash-attention kernels against their plain versions, at
    the captioning decoder's cross-attention shapes and at the equal-length
    shapes the JAX package runs its kernel at; layouts; determinism."""
    from vipant_tpu_torch.ops import attention as attention_mod, kernels

    rn = _seeded(torch)
    pack_bias, _ = _biases(torch)
    for case, B, Tq, Tk, H, kind in FLASH_CASES:
        cmp = lambda *a, **k: compare(torch, results, *a, iters=10, **k)
        q, k, v, do = rn(B, Tq, H, 64), rn(B, Tk, H, 64), rn(B, Tk, H, 64), rn(B, Tq, H, 64)
        bias = flash_bias(torch, kind, Tq)
        o, lse = kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125)
        lib_fwd, lib_bwd, lib_dbias = _sdpa4(torch, q, k, v, bias)
        fwd = lambda: kernels.flash_attention_fwd(q, k, v, bias, 0.125)
        cmp("flash_attention_fwd", case, fwd, lambda: kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125),
            reads=(q, k, v, bias), ops=flash_ops(B, Tq, Tk, H), library=lib_fwd, device=True)
        if not all(torch.equal(a, b) for a, b in zip(fwd(), fwd())):
            raise AssertionError(f"flash_attention_fwd {case}: two runs differ")
        bwd = lambda: kernels.flash_attention_bwd(q, k, v, bias, o, lse, do, 0.125)
        cmp("flash_attention_bwd", case, bwd,
            lambda: kernels.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, 0.125),
            reads=(q, k, v, bias, o, lse, do), ops=flash_ops(B, Tq, Tk, H, 5), library=lib_bwd(do),
            device=True)
        if not all(torch.equal(a, b) for a, b in zip(bwd(), bwd())):
            raise AssertionError(f"flash_attention_bwd {case}: two runs differ")
        if bias is None:
            if "causal" in case:
                raise AssertionError("the causal case lost its bias")
            continue
        delta = kernels.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, 0.125)[3]
        dbias = lambda: kernels.flash_attention_dbias(q, k, v, bias, lse, delta, do, 0.125)
        # the first of these cases is the probe path's shape: the packing bias with its grad
        cmp("flash_attention_dbias", case, dbias,
            lambda: kernels.flash_attention_dbias_plain(q, k, v, bias, lse, delta, do, 0.125),
            reads=(q, k, v, bias, lse, delta, do), ops=flash_ops(B, Tq, Tk, H), library=lib_dbias(do),
            device=True)
        if not torch.equal(dbias(), dbias()):
            raise AssertionError(f"flash_attention_dbias {case}: two runs differ")
        # on small integers every product is exact, so the kernel's ds_raw is the plain version's
        # bit for bit and its sum must be the plain sum in the kernel's order
        gi = torch.Generator(device="cuda").manual_seed(1)
        qi, ki, vi, doi = (torch.randint(-2, 3, t.shape, generator=gi, device="cuda").to(t.dtype)
                           for t in (q, k, v, do))
        oi, lsei = kernels.flash_attention_fwd_plain(qi, ki, vi, bias, 0.125)
        deltai = kernels.flash_attention_bwd_plain(qi, ki, vi, bias, oi, lsei, doi, 0.125)[3]
        if not torch.equal(kernels.flash_attention_dbias(qi, ki, vi, bias, lsei, deltai, doi, 0.125),
                           kernels.flash_attention_dbias_ordered(qi, ki, vi, bias, lsei, deltai, doi, 0.125)):
            raise AssertionError(f"flash_attention_dbias {case}: differs from flash_attention_dbias_ordered")
        # causal=True through the public op is the same bias folded on the host
        if "causal" in case and not torch.equal(attention_mod.flash_attention(q, k, v, causal=True),
                                                kernels.flash_attention_fwd(q, k, v, bias, 0.125)[0]):
            raise AssertionError("flash_attention(causal=True) differs from the causal bias")
    print("  dq, dk, dv: two runs bitwise equal at every case; bias grad: two runs bitwise equal and "
          "bitwise flash_attention_dbias_ordered on small integers at T77 causal and T200 pack")

    # the same values as contiguous tensors, sections of a packed [B, T, 3C] and [B, H, T, D] views
    B, T, H = 16, 200, 12
    packed = rn(B, T, 3 * H * 64)
    do = rn(B, T, H, 64)
    bias = pack_bias(50, 4)
    sections = packed.view(B, T, 3, H, 64).unbind(dim=2)
    layouts = {
        "packed sections": sections,
        "contiguous": tuple(t.contiguous() for t in sections),
        "transposed [B, H, T, D]": tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in sections),
    }
    outs = {}
    for name, (q, k, v) in layouts.items():
        o, lse = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
        grads = kernels.flash_attention_bwd(q, k, v, bias, o, lse, do, 0.125)
        outs[name] = (o, lse, *grads, kernels.flash_attention_dbias(q, k, v, bias, lse, grads[3], do, 0.125))
    ref = outs["contiguous"]
    for name, got in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"flash kernels: layout {name!r} differs from contiguous inputs")
    print(f"  layouts {list(layouts)}: o, lse, dq, dk, dv, delta, dbias bitwise equal")
    # a query row masked everywhere (bias -1e30 across it) is the uniform row, not NaN
    q, k, v = rn(4, 77, 8, 64), rn(4, 61, 8, 64), rn(4, 61, 8, 64)
    bias = torch.zeros(77, 61, device="cuda")
    bias[40] = -1e30
    o, lse = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
    o0, lse0 = kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125)
    keep = torch.arange(77, device="cuda") != 40  # the masked row's lse is -1e30 in both
    check_default(torch, [o, lse[..., keep]], [o0, lse0[..., keep]], "flash_attention_fwd, a row masked everywhere")
    if not bool((lse[..., 40] == lse0[..., 40]).all()):
        raise AssertionError("flash_attention_fwd: the masked row's lse differs from the plain version's")
    if not torch.allclose(o[:, 40].float(), v.float().mean(dim=1), atol=ATOL, rtol=RTOL):
        raise AssertionError("flash_attention_fwd: a row masked everywhere is not the uniform row")
    print("  flash_attention_fwd: a row masked everywhere is the uniform row")
    for bad, why in (((sections[0].float(), *sections[1:]), "fp32"),
                     ((rn(B, T, H, 32), rn(B, T, H, 32), rn(B, T, H, 32)), "D = 32")):
        try:
            kernels.flash_attention_fwd(*bad, None, 0.125)
        except ValueError:
            continue
        raise AssertionError(f"flash_attention_fwd took {why} inputs on the card")


def check_dot(torch, got, want, what):
    """dot_variant's fp32 product: max |d| <= DOT_TOL beside the default gate."""
    err, errs = check_default(torch, got, want, what)
    if err > DOT_TOL:
        raise AssertionError(f"{what}: max|d| {err:.3e} > {DOT_TOL}")
    return err, errs


def dot_variant_cases(torch, results):
    """``dot_variant`` at every ``DOT_CASES`` case and orientation: the
    launch ``vt_dot_plan`` reports equal to ``kernels.dot_plan``; one seeded
    logical product stored four ways, each held to its plain version, with
    device µs beside ``torch.matmul``'s on the same stored operands; two
    runs bitwise equal, and the four orientations bitwise equal to each
    other; at K = 0, zeros."""
    import ctypes

    from vipant_tpu_torch.ops import _build, kernels

    rn = _seeded(torch)
    for case, M, K, N in DOT_CASES:
        plan = (ctypes.c_int * 3)()
        _build.library().vt_dot_plan(M, N, K, plan)
        if tuple(plan) != tuple(kernels.dot_plan(M, N, K)):
            raise AssertionError(f"dot_variant {case}: launch {tuple(plan)} != {kernels.dot_plan(M, N, K)}")
        A, B = rn(M, K), rn(K, N)
        outs = {}
        for name, (ta, tb) in kernels.ORIENTATIONS.items():
            a, b = (A.t().contiguous() if ta else A), (B.t().contiguous() if tb else B)
            lib = lambda a=a, b=b, ta=ta, tb=tb: torch.matmul(a.t() if ta else a, b.t() if tb else b)
            call = lambda a=a, b=b, name=name: kernels.dot_variant(a, b, name)
            compare(torch, results, "dot_variant", f"{name} {case}", call,
                    lambda a=a, b=b, name=name: kernels.dot_variant_plain(a, b, name),
                    reads=(a, b), ops=gemm_ops(M, N, K), library=lib, check=check_dot, device=True)
            outs[name] = call()
            if not torch.equal(outs[name], call()):
                raise AssertionError(f"dot_variant {name} {case}: two runs differ")
            zero = kernels.dot_variant(a[:0] if ta else a[:, :0], b[:, :0] if tb else b[:0], name)
            if zero.shape != (M, N) or bool(zero.any()):
                raise AssertionError(f"dot_variant {name} {case} at K = 0: not an [M, N] of zeros")
        worst = max((o - outs["NN"]).abs().max().item() for o in outs.values())
        if worst != 0.0:
            raise AssertionError(f"dot_variant {case}: the four orientations differ by up to {worst:.3e}")
        print(f"  dot_variant {case}: launch {tuple(plan)} (tile, stages, blocks) as kernels.dot_plan; "
              f"NN, NT, TN, TT bitwise equal, each bitwise across two runs; K = 0 gives zeros")


def probe_phase(torch, results):
    """The two probe kernels, then the probe path with its launches counted."""
    from vipant_tpu_torch.experiments import fused_block_probe as probe
    from vipant_tpu_torch.nn.layers import pack_tokens
    from vipant_tpu_torch.ops import LAUNCHES, attention as attention_mod, fused_attn, reset_launches

    dot_variant_cases(torch, results)
    args = probe.make_inputs(device="cuda")
    B, T, C = args[0].shape
    x, wqkv, bqkv, wout, bout = args
    xt, bqkv_b, bout_b = x.transpose(0, 1), bqkv.to(x.dtype), bout.to(x.dtype)  # the library is sequence-first
    mha = lambda: torch.nn.functional.multi_head_attention_forward(
        xt, xt, xt, C, probe.H, wqkv, bqkv_b, None, None, False, 0.0, wout, bout_b, need_weights=False)
    compare(torch, results, "probe_fused_fwd", f"B{B} T{T} C{C} H{probe.H}",
            lambda: probe.probe_fused_fwd(*args), lambda: probe.probe_fused_fwd_plain(*args),
            reads=args, iters=10, library=mha,
            ops=gemm_ops(B * T, 3 * C, C) + attn_ops(B, T, probe.H) + gemm_ops(B * T, C, C),
            also={"fused_attention_block_ms": lambda: fused_attn.fused_attention_block(*args, heads=probe.H)})
    out, block = probe.probe_fused_fwd(*args)[0], fused_attn.fused_attention_block(*args, heads=probe.H)
    err, _ = check_default(torch, [out], [block], "probe_fused_fwd against fused_attention_block")
    print(f"  probe_fused_fwd against the fused_attention_block chain (other attention kernel): "
          f"max|d| {err:.2e} within atol = rtol = {ATOL}")

    # the probe path: its launches are counted from here
    rn = _seeded(torch)
    q, k, v = (rn(16, 200, 12, 64).requires_grad_() for _ in range(3))
    bias = pack_tokens(torch.zeros(4, 50, 1, device="cuda"), 4)[1].requires_grad_()
    reset_launches()
    report = probe.probe_dot_variants("cuda")
    out, lse = probe.probe_fused_fwd(*args)
    o = attention_mod.flash_attention(q, k, v, bias=bias)  # the public op: bias_grad=True
    grads = torch.autograd.grad(o, (q, k, v, bias), torch.ones_like(o))
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"launches on the probe path: {json.dumps(counts, sort_keys=True)}")
    want = {"dot_variant": 4, "probe_fused_fwd": 1, "gemm_bias_act": 2, "flash_attention_fwd": 2,
            "flash_attention_bwd": 1, "flash_attention_dbias": 1}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    record_launches(results, "probe", counts)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, *grads))
    if not finite or max(report.values()) > 1e-3 or not bool(grads[3].any()):
        raise AssertionError(f"probe path: finite {finite}, dot variants {report}")
    print("  dot variants on the path: " + ", ".join(f"{k} max|d| {v:.2e}" for k, v in report.items()))


def _caption_trainer(torch, B, *extra):
    from vipant_tpu_torch.train import Trainer

    torch.cuda.empty_cache()
    return Trainer(CAPTION_FULL + [f"running.batch_size={B}", *extra],  # on the card, the default
                   steps_per_epoch=STEPS_PER_EPOCH)


def _caption_batch(tr, rng, B, ctx=77, vocab=49408):
    """(fbank, ids): ids as the tokenizer lays them out (sot, 5-20 words,
    eot, zero padding)."""
    ids = np.zeros((B, ctx), np.int64)
    for row in ids:
        n = int(rng.integers(5, 21))
        row[0], row[1:1 + n], row[1 + n] = vocab - 2, rng.integers(1, vocab - 2, n), vocab - 1
    return tr.make_batch(rng.standard_normal((B, 1, 1000, 128)).astype(np.float32), ids)


def caption_train_phase(torch, results):
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.train import loss_and_grads

    # (a) one init and batch (B = 16): kernels against the plain ops and against fp32
    B = 16
    tr = _caption_trainer(torch, B)
    audio_layers, dec_layers = len(tr.model.audio.encoder.resblocks), len(tr.model.decoder.transformer.resblocks)
    n_dec = sum(p.numel() for k, p in tr.trainable.items() if k.startswith("decoder."))
    print(f"captioning step: audio tower {audio_layers} layers, grid {tr.model.audio.grid}; decoder "
          f"{dec_layers} layers, width {tr.model.decoder.width}, vocabulary {tr.model.decoder.vocab_size}; "
          f"{sum(p.numel() for p in tr.trainable.values()):,} trainable params ({n_dec:,} in the decoder), "
          f"{len(tr.frozen)} frozen; loss kwargs {tr.state.loss_kwargs}")
    if tr.frozen or tr.state.loss_kwargs != {"retrieval": False}:
        raise AssertionError("the captioning trainer froze something or trains retrieval")
    batch = _caption_batch(tr, np.random.default_rng(0), B)
    k_run = loss_and_grads(tr.state, *batch)
    with plain_ops():
        p_run = loss_and_grads(tr.state, *batch)
        ref = _caption_trainer(torch, B, "compute_dtype=float32")  # same seed: same init
        f_run = loss_and_grads(ref.state, *batch)
    del ref
    hold_grads_to_fp32(torch, f"(a) B={B}", "captioning", k_run, p_run, f_run)
    if bool(k_run[1]["decoder.text_proj"].any()):
        raise AssertionError("text_proj got a grad: the LM loss does not reach it")
    del k_run, p_run, f_run

    # (b) the captioning training path: its launches are counted from here, one step
    init = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    reset_launches()
    losses = [float(tr.train_step(*batch)["loss"])]
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"(b) launches in one captioning step: {json.dumps(counts, sort_keys=True)}")
    blocks = audio_layers + dec_layers  # every sub-block runs forward and backward
    want = {
        "fused_ln_attention_block": blocks, "fused_ln_mlp_block": blocks,
        "fused_ln_attention_block_bwd": blocks, "fused_ln_mlp_block_bwd": blocks,
        "layernorm_fwd": 4 * blocks, "gemm_bias_act": 5 * blocks, "attention_fwd": blocks,
        "attention_bwd": blocks, "layernorm_bwd": 2 * blocks, "colsum": 4 * blocks,
        "gemm_dgrad": 4 * blocks, "gemm_wgrad": 4 * blocks,
        "flash_attention_fwd": dec_layers, "flash_attention_bwd": dec_layers,  # and no bias grad
        "patch_gather": 1,  # the audio tower
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    record_launches(results, "caption_train", counts)
    losses += [float(tr.train_step(*batch)["loss"]) for _ in range(2)]
    moved = [k for k, p in tr.trainable.items() if not torch.equal(p.detach(), init[k])]
    print(f"    LARS losses {[round(v, 5) for v in losses]}; {len(moved)} of {len(tr.trainable)} "
          f"trainable params moved in 3 steps")
    if not np.isfinite(losses).all() or not any("cross_attn" in k for k in moved):
        raise AssertionError("captioning LARS steps: non-finite loss or the cross-attention did not move")
    del tr, batch, init

    # (c) time at B = 64, kernels against plain ops
    B = 64
    tr = _caption_trainer(torch, B)
    batch = _caption_batch(tr, np.random.default_rng(1), B)

    def fwd():
        with torch.no_grad():
            return tr.model(*batch, train=True, **tr.state.loss_kwargs)

    timing = {}
    for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_ops)):
        with ctx():
            timing[label] = {"fwd": cuda_ms(torch, fwd, 5, 2),
                             "fwd_bwd": cuda_ms(torch, lambda: loss_and_grads(tr.state, *batch), 5, 2),
                             "step": cuda_ms(torch, lambda: tr.train_step(*batch), 5, 2)}
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(*batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for label, t in timing.items():
        print(f"(c) B={B} {label}: {t['step']:.2f} ms/step ({B / t['step'] * 1e3:.1f} clips/s): "
              f"fwd {t['fwd']:.2f}, fwd+bwd {t['fwd_bwd']:.2f}, "
              f"optimizer and the rest {t['step'] - t['fwd_bwd']:.2f} ms")
    print(f"(c) peak device memory of a kernel step at B={B}: {peak:.2f} GiB")
    busy, span, by_name = _profile(torch, lambda: tr.train_step(*batch))
    step_ms = timing["kernels"]["step"]
    print(f"(c) profiler, kernel step at B={B}: device busy {busy:.2f} ms / span {span:.2f} ms per "
          f"step (idle {100 * max(0.0, 1 - busy / step_ms):.1f} % of the untraced {step_ms:.2f} ms "
          f"step); top kernels by device time per step:")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"    {d / 3:9.3f} ms  {n // 3:5d}x  {name[:90]}")
    flash = {n[n.index("flash_"):].split("(")[0]: d / 3 for n, (_, d) in by_name.items() if "flash_" in n}
    print("    flash kernels per step: " + ", ".join(f"{n} {d:.3f} ms" for n, d in flash.items()))
    del tr, batch

    # (d) Adam descent smoke on one fixed batch
    B, n_steps = 32, 60
    tr = _caption_trainer(torch, B, "optimizer.use_lars=False", "optimizer.warmup=False",
                          "optimizer.lr=1.0e-4")
    batch = _caption_batch(tr, np.random.default_rng(7), B)
    k = np.asarray([float(tr.train_step(*batch)["loss"]) for _ in range(n_steps)])
    print(f"(d) Adam B={B}, one fixed batch: LM loss {np.round(k[::5], 4).tolist()} ... last 5 mean "
          f"{k[-5:].mean():.4f}")
    if not (np.isfinite(k).all() and k[-5:].mean() < 0.9 * k[0]):
        raise AssertionError(f"captioning Adam smoke did not descend: {k.tolist()}")


def _caption_engine(torch, batch_size, quantize=""):
    from vipant_tpu_torch.serve import InferenceEngine

    torch.cuda.empty_cache()
    return InferenceEngine(CAPTION_FULL, batch_size=batch_size, seed=0, quantize=quantize)  # on the card


def caption_serve_phase(torch, results):
    from vipant_tpu_torch.models.tasks import _encode
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches

    eng = _caption_engine(torch, BATCH)
    dec = eng.model.decoder
    L, audio_layers, dec_layers = dec.max_len_dec, len(eng.model.audio.encoder.resblocks), dec.layers
    fb = np.random.default_rng(0).standard_normal((6, 1000, 128)).astype(np.float32)

    # the captioning serving path: its launches are counted from here
    reset_launches()
    greedy = eng.caption(fb)           # 2 chunks of 4, the last padded
    beamed = eng.caption(fb[:3], beam=4)  # 1 chunk, 16 hypotheses
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"launches on the captioning serving path: {json.dumps(counts, sort_keys=True)}")
    chunks = 3
    mlp = chunks * (audio_layers + L * dec_layers)  # the audio tower's, and one per layer and decode step
    want = {"fused_ln_attention_block": chunks * audio_layers, "attention_fwd": chunks * audio_layers,
            "fused_ln_mlp_block": mlp, "layernorm_fwd": chunks * audio_layers + mlp,
            "gemm_bias_act": 2 * chunks * audio_layers + 2 * mlp, "patch_gather": chunks}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    record_launches(results, "caption_serve", counts)
    if len(greedy) != 6 or len(beamed) != 3 or not all(isinstance(c, str) for c in greedy + beamed):
        raise AssertionError(f"caption output malformed: {greedy} {beamed}")
    print(f"  captions of seeded random weights (greedy, first 2): {[c[:60] for c in greedy[:2]]}")
    if eng.caption(fb[:BATCH], beam=1) != greedy[:BATCH]:
        raise AssertionError("beam=1 does not give the greedy captions")

    # KV-cached greedy against the re-forward decoder (which runs the flash kernel), batch 4
    with torch.inference_mode():
        audios = torch.from_numpy(fb[:BATCH, None]).to(eng.device)
        _, feat = _encode(eng.model.audio, audios, False, require_feature=True)
        reset_launches()
        ids_r, logits_r = dec.greedy_decode(feat)
        reforward_flash = LAUNCHES["flash_attention_fwd"]
        ids_k, logits_k = dec.greedy_decode_kv(feat)
        ids_b1, _ = dec.beam_decode_kv(feat, beam=1)
        # the re-forward decoder's ids fed through the KV-cached step at every position:
        # no row is cut off by a flipped token
        memory, states, forced = dec._memory(feat), dec._init_states(BATCH, eng.device), []
        for t in range(L):
            step_logits, states = dec._one_step(ids_r[:, t], t, memory, states)
            forced.append(step_logits)
        forced_d = (torch.stack(forced, dim=1).float() - logits_r.float()).abs().amax(dim=(0, 2)).cpu().numpy()
        # teacher-forced logits on the kernels against the plain ops
        ids_tf = torch.zeros((BATCH, 77), dtype=torch.long, device=eng.device)
        ids_tf[:, :L + 1] = ids_k
        _, tf_k = dec(ids_tf, feat)
        with plain_ops():
            _, tf_p = dec(ids_tf, feat)
    if reforward_flash != L * dec_layers:
        raise AssertionError(f"the re-forward decoder launched the flash kernel {reforward_flash} times")
    if not torch.equal(ids_b1, ids_k):
        raise AssertionError("beam_decode_kv(beam=1) differs from greedy_decode_kv")
    top2 = logits_r.float().topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    same = (ids_r == ids_k).cpu().numpy()[:, 1:]
    worst = 0.0
    for row in range(BATCH):
        first = L if same[row].all() else int(np.argmin(same[row]))
        upto = min(first + 1, L)  # a differing token feeds different inputs to every later step
        d = (logits_r[row, :upto].float() - logits_k[row, :upto].float()).abs().max().item()
        worst = max(worst, d)
        if d > DECODE_TOL or (first < L and margin[row, first] > DECODE_TOL):
            raise AssertionError(f"row {row}: KV-cached decode differs from the re-forward decode by {d} "
                                 f"up to step {first}, margin there {margin[row, min(first, L - 1)]}")
    print(f"  KV-cached steps forced to the re-forward decoder's ids, all {L} positions: per-step logits "
          f"max|d| {forced_d.max():.4f} (at step {int(forced_d.argmax())}; tolerance {DECODE_TOL}; "
          f"max |logit| {logits_r.float().abs().max().item():.2f})")
    if not forced_d.max() <= DECODE_TOL:
        raise AssertionError(f"KV-cached steps on the re-forward decoder's ids differ from its logits by "
                             f"{forced_d.tolist()} per step")
    cos = torch.nn.functional.cosine_similarity(tf_k.float(), tf_p.float(), dim=-1).min().item()
    print(f"  KV-cached against re-forward greedy decode (batch {BATCH}): per-step logits max|d| "
          f"{worst:.4f} up to each row's first differing token (tolerance {DECODE_TOL}); "
          f"{100 * same.mean():.1f} % of ids equal; median top-2 margin {np.median(margin):.4f}; "
          f"re-forward decode launched flash_attention_fwd {reforward_flash}x")
    print(f"  teacher-forced logits, kernels against plain ops: min cosine {cos:.6f}")
    if cos < COS_MIN:
        raise AssertionError(f"teacher-forced logits cosine {cos} < {COS_MIN}")

    def timings(en, B):
        """ms per caption batch, greedy and beam 4, and the decode alone
        (one timed call each after a warm-up: the phase's time is bounded)."""
        fbb = np.random.default_rng(1).standard_normal((B, 1000, 128)).astype(np.float32)
        with torch.inference_mode():
            _, f = _encode(en.model.audio, torch.from_numpy(fbb[:, None]).to(en.device), False,
                           require_feature=True)
            row = {"caption greedy": _timed_ms(torch, lambda: en.caption(fbb), 1),
                   "caption beam=4": _timed_ms(torch, lambda: en.caption(fbb, beam=4), 1),
                   "greedy_decode_kv": _timed_ms(torch, lambda: en.model.decoder.greedy_decode_kv(f), 1),
                   "beam_decode_kv(4)": _timed_ms(torch, lambda: en.model.decoder.beam_decode_kv(f, beam=4), 1)}
            with plain_ops():
                row["caption greedy, plain ops"] = _timed_ms(torch, lambda: en.caption(fbb), 1)
        print(f"  batch {B}: " + "; ".join(
            f"{k} {v:.2f} ms" + (f" ({v / L:.3f} ms per decode step)" if "decode" in k else "")
            for k, v in row.items()))

    # the same weights with quantize="int8": the decoder's fused sub-blocks decode in int8
    eng8 = _caption_engine(torch, BATCH, "int8")
    reset_launches()
    greedy8 = eng8.caption(fb[:BATCH])
    c8 = dict(LAUNCHES)
    if (c8.get("fused_ln_mlp_block_int8") != audio_layers + L * dec_layers
            or c8.get("fused_ln_attention_block_int8") != audio_layers
            or any(n in c8 for n in ("fused_ln_mlp_block", "fused_ln_attention_block"))):
        raise AssertionError(f"int8 captioning launches: {c8}")
    words = lambda cs: [w for c in cs for w in c.split()]
    print(f"  quantize='int8': {sum(a == b for a, b in zip(greedy8, greedy))} of {BATCH} captions equal "
          f"to bf16's ({len(words(greedy8))} against {len(words(greedy[:BATCH]))} words); int8 launches "
          f"{ {k: v for k, v in c8.items() if 'int8' in k} }")
    del eng, eng8
    eng = _caption_engine(torch, 64)
    timings(eng, 64)


# phase 14: the VA epoch loop on a synthetic index
LOOP_TRAIN, LOOP_EVAL, LOOP_B, LOOP_SECONDS, LOOP_FRAME = 256, 64, 64, 10.0, 256
# the timed indexes: the wav train split once (4 steps), the npz split 3 times (12 steps)
LOOP_WAV_REPEAT, LOOP_NPZ_REPEAT = 1, 3
# (g): the side stream sleeps before each copy, the compute stream between a batch's two reads;
# the next copy lands RACE_COPY_MS after the last, well before the second read
RACE_COPY_MS, RACE_READ_MS, RACE_BATCHES = 100, 250, 3


def write_synthetic_va(root, name, n, seconds=LOOP_SECONDS, frame_size=LOOP_FRAME, seed=0,
                       frames=True, npz_name=None, mel=128, frames_npz=1000):
    """A seeded synthetic VA index in the layout of the JAX package's test
    fabrication (``tests/data_synth.py:make_synth_va_index``):
    ``{root}/aclip/{id}.wav`` (16 kHz mono, a tone per clip plus noise),
    ``{root}/frame/{id}.0.jpg`` (``frame_size`` square, seeded noise; left out
    with ``frames=False``) and ``{root}/{name}.jsonl``. With ``npz_name``, an
    npz twin ``{root}/{npz_name}.jsonl`` whose records point at
    ``{root}/aclip/{id}.npz``: a precomputed ``frames_npz`` x ``mel`` fbank
    under ``feat`` (seeded normal values, as the JAX tests' npz index)."""
    import os

    from vipant_tpu_torch.data import write_wav

    sr = 16000
    os.makedirs(os.path.join(root, "aclip"), exist_ok=True)
    if frames:
        from PIL import Image

        os.makedirs(os.path.join(root, "frame"), exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    records, twins = [], []
    for i in range(n):
        cid = f"{name}{i}"
        wav = 0.4 * np.sin(2 * np.pi * (200 + 7 * i) * t) + 0.01 * rng.standard_normal(len(t))
        write_wav(os.path.join(root, "aclip", f"{cid}.wav"), wav.astype(np.float32), sr)
        rec = {"id": cid, "dir": "", "aclip": ["wav"]}
        if frames:
            img = (rng.random((frame_size, frame_size, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, "frame", f"{cid}.0.jpg"))
            rec["frame"] = ["0.jpg"]
        records.append(rec)
        if npz_name:
            np.savez(os.path.join(root, "aclip", f"{cid}.npz"),
                     feat=rng.standard_normal((frames_npz, mel)).astype(np.float32))
            twins.append({**rec, "aclip": ["npz"]})
    for index, recs in ((name, records), (npz_name, twins)):
        if index:
            with open(os.path.join(root, f"{index}.jsonl"), "w") as f:
                f.write("".join(json.dumps(r) + "\n" for r in recs))
    return records


def _loop_trainer(torch, root, run_dir, *extra):
    import os

    from vipant_tpu_torch.train import Trainer

    torch.cuda.empty_cache()
    return Trainer(FLAGSHIP + [
        f"running.data_root={root}", "running.data_name=train", "running.eval_name=val",
        f"running.batch_size={LOOP_B}", "running.epochs=2", "loader_backend=process",
        f"num_proc={min(8, os.cpu_count() or 1)}", "running.peep_rate=1", "running.save_rate=6",
        "running.save_epoch=True", f"alias_root={run_dir}", f"model_root={run_dir}",
        "model_name=loop", "eval=False", "metrics_jsonl=True", "keep_last_ckpts=2", *extra])


def _loop_losses(tr):
    import os

    with open(os.path.join(tr.out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f if line.strip()]


def _timed_epoch(torch, tr, ie, tail=0, head=0):
    """Epoch ``ie`` from idle workers, timed in its steady state: from the
    arrival of its batch ``head`` (0: its first) to the arrival of the batch
    ``tail`` before its last. The wait for a whole batch after idle workers
    stays out; with ``head``, the batches a loader that is behind the
    trainer made alongside the first (it has ``prefetch + 1`` batches in
    flight from the start) do too; with ``tail``, the last steps of a
    loader that runs ahead of the trainer: it holds ``2 * prefetch + 2``
    batches ready once it has no items left to submit, and the steps after
    that run with its workers idle. Returns (ms per step, clips/s, the
    window's share spent waiting for the loader, steps in the window, each
    step's (wait, step call) ms)."""
    from vipant_tpu_torch.utils import PhaseTimer

    log = []  # (phase, when it stopped, seconds)

    class Logged(PhaseTimer):
        def stop(self, phase):
            dt = super().stop(phase)
            log.append((phase, time.perf_counter(), dt))
            return dt

    tr.timer = Logged()
    tr.loader.set_epoch(ie)
    tr.epoch(ie)
    torch.cuda.synchronize()
    arrivals = [(t, dt) for phase, t, dt in log if phase == "data"][:-1]  # the last: no batch
    calls = [dt for phase, _, dt in log if phase == "model"]
    end = len(arrivals) - 1 - tail
    steps, window = end - head, arrivals[end][0] - arrivals[head][0]
    wait = sum(dt for _, dt in arrivals[head + 1:end + 1])
    series = [(round(1e3 * w), round(1e3 * c)) for (_, w), c in zip(arrivals, calls)]
    return window / steps * 1e3, steps * tr.loader.batch_size / window, wait / window, steps, series


def _trace_window(path):
    """A ``torch.profiler`` Chrome trace: (span ms, device busy ms (kernels,
    copies and fills merged on the timeline), per host thread the ms inside
    its torch ops (merged), most first)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]

    def merged(spans):
        spans, total, cur = sorted(spans), 0.0, None
        for s, t in spans:
            if cur is None or s > cur[1]:
                total += 0 if cur is None else cur[1] - cur[0]
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
        return (total + (cur[1] - cur[0] if cur else 0)) / 1e3

    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            host.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    if not device:
        raise AssertionError("the loop's profiler window saw no device activity")
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    by_thread = sorted(((merged(v), len(v)) for v in host.values()), reverse=True)
    return span, merged(device), by_thread


def _race_check(torch, PinnedDevicePut, batches):
    """The pinned copy against the races it guards: each copy waits
    ``RACE_COPY_MS`` on the side stream before it runs (several times the
    host's write of a batch into its pinned buffers), and each batch is read
    twice on the compute stream with no host sync between: at once after
    ``wait`` (a missing ``wait_event`` reads the copy's destination before it
    lands) and again after ``RACE_READ_MS`` of sleep queued there, when the
    batch's tensors have been dropped and the next batch's copy has run (a
    missing ``record_stream`` lets the allocator give that copy the same
    memory).
    The keys are the batches' own (token ids keep their int32 dtype).
    Returns, for the real put and for two puts that each leave one of the
    two out, the batches whose early and late reads differ from the host's."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    per_ms = 10 ** 7 / start.elapsed_time(end)
    copy_delay, read_delay = int(RACE_COPY_MS * per_ms), int(RACE_READ_MS * per_ms)
    keys = tuple(batches[0])

    class Delayed(PinnedDevicePut):
        def __call__(self, batch):
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(copy_delay)
            return super().__call__(batch)

    class NoWaitEvent(Delayed):
        def wait(self, batch):
            batch.pop("_copied")
            out = tuple(batch[k] for k in self.keys)
            for t in out:
                t.record_stream(torch.cuda.current_stream())
            return out

    class NoRecordStream(Delayed):
        def wait(self, batch):
            torch.cuda.current_stream().wait_event(batch.pop("_copied"))
            return tuple(batch[k] for k in self.keys)

    from concurrent.futures import ThreadPoolExecutor

    found = {}
    for put_cls in (Delayed, NoWaitEvent, NoRecordStream):
        put, early, late = put_cls(keys), [], []
        with ThreadPoolExecutor(max_workers=1) as xfer:  # as the loader's transfer thread
            for hb in batches:
                placed = xfer.submit(put, {k: hb[k] for k in keys}).result()
                tensors = put.wait(placed)
                early.append([t.clone() for t in tensors])
                torch.cuda._sleep(read_delay)
                late.append([t.clone() for t in tensors])
                del placed, tensors  # while the compute stream still has to read them
        torch.cuda.synchronize()
        differ = lambda reads: sum(any(t.dtype != torch.from_numpy(hb[k]).dtype
                                       or not np.array_equal(t.cpu().numpy(), hb[k])
                                       for t, k in zip(r, keys)) for r, hb in zip(reads, batches))
        found[put_cls.__name__] = (differ(early), differ(late))
        del put, early, late
    return found


def _snapshot(tr):
    """A trainer's trainable params, LARS buffers and RNG state, copied."""
    return ({k: p.detach().clone() for k, p in tr.trainable.items()},
            tr.state.optimizer.state_dict()["inner"]["state"], tr.state.generator.get_state())


def _resume_diff(torch, tr, snap):
    """Name -> max |d| of each param, optimizer buffer and the RNG state of
    ``tr`` that is not bitwise ``snap``'s; and the counts compared."""
    params, opt, rng = snap
    got_opt = tr.state.optimizer.state_dict()["inner"]["state"]
    diff = {k: (p.detach() - params[k]).abs().max().item() for k, p in tr.trainable.items()
            if not torch.equal(p.detach(), params[k])}
    diff.update({f"optimizer state {i}/{n}": (v - opt[i][n]).abs().max().item()
                 for i, st in got_opt.items() for n, v in st.items()
                 if torch.is_tensor(v) and not torch.equal(v, opt[i][n])})
    if not torch.equal(tr.state.generator.get_state(), rng):
        diff["rng state"] = float("inf")
    return diff, f"{len(tr.trainable)} params, {len(got_opt)} optimizer buffers and the RNG"


def loop_phase(torch, results):
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.data import build_image_audio_dataloader
    from vipant_tpu_torch.data.device_put import PinnedDevicePut
    from vipant_tpu_torch.eval.metrics import format_retrieval_report, symmetric_retrieval
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.serve import InferenceEngine
    from vipant_tpu_torch.train import eval_step

    smi = _smi()
    try:
        import PIL  # noqa: F401
        frames = True
    except ImportError:
        frames = False
        print("PIL is not installed: the records have no frame, and the frozen image tower "
              "encodes the zero image of the dataset's frame=None branch")
    root = tempfile.mkdtemp(prefix="vipant_loop_")
    workers = min(8, os.cpu_count() or 1)
    try:
        t0 = time.perf_counter()
        write_synthetic_va(root, "train", LOOP_TRAIN, frames=frames, npz_name="npz_train", seed=0)
        write_synthetic_va(root, "val", LOOP_EVAL, frames=frames, seed=1)
        print(f"synthetic index: {LOOP_TRAIN} train + {LOOP_EVAL} eval clips of {LOOP_SECONDS:.0f} s "
              f"16 kHz wav, {'a ' + str(LOOP_FRAME) + 'x' + str(LOOP_FRAME) + ' JPEG each' if frames else 'no frames'}, "
              f"an npz twin of the train split (1000x128 fbanks), written in "
              f"{time.perf_counter() - t0:.1f} s")

        # (a) run A: 8 steps uninterrupted, a mid-epoch save and eval at step 6; the loop's launches
        run = os.path.join(root, "run")
        a = _loop_trainer(torch, root, run, "running.save_epoch=False")
        init = {k: p.detach().clone() for k, p in a.trainable.items() if k.startswith("audio.")}
        moved = {}
        apply = a.state.optimizer.apply

        def apply_and_look(grads):
            out = apply(grads)
            if a.state.optimizer.count == 2:
                moved.update({k: not torch.equal(a.trainable[k], p) for k, p in init.items()})
            return out

        a.state.optimizer.apply = apply_and_look
        t0 = time.perf_counter()
        reset_launches()
        a.learn()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        a.save()  # step 8, for the engine below
        print(f"(a) run A: {a.global_step} steps (2 epochs of {a.steps_per_epoch}), a save and an eval "
              f"at step 6, in {time.perf_counter() - t0:.1f} s, then a save at 8; launches "
              f"{json.dumps(counts, sort_keys=True)}")
        record_launches(results, "va_loop", counts)
        del init
        # (c) finite losses, the audio tower moved by step 2
        losses = _loop_losses(a)
        print(f"(c) losses {[round(v, 5) for v in losses]}; {sum(moved.values())} of {len(moved)} "
              f"audio params moved by step 2")
        if len(losses) != 8 or not np.isfinite(losses).all() or not any(moved.values()):
            raise AssertionError("run A: non-finite loss, missing steps, or the audio tower did not move")

        # (d) the retrieval report on the eval clips, and (e) the port's engine on A's step 8
        batch = next(iter(a.evalloader))
        a.close()
        x1, x2 = (v.float().cpu().numpy() for v in eval_step(
            a.model, *a.make_batch(batch["image"], batch["audio"])))
        sym = symmetric_retrieval(x1, x2)
        print(f"(d) {format_retrieval_report(sym, len(x1))}; I->A {sym['12']}")
        if not all(np.isfinite(v) for d in sym.values() for v in d.values()):
            raise AssertionError(f"retrieval report is not finite: {sym}")
        want = _snapshot(a)
        del a
        torch.cuda.empty_cache()
        eng = InferenceEngine(FLAGSHIP + [f"model_root={run}", "model_name=loop",
                                          "model_file=00000008"], batch_size=LOOP_B)
        got = eng.embed_audio(batch["audio"][:, 0])
        cos = _row_cos(got, x2)
        print(f"(e) InferenceEngine on step 8's model.npz (+ state.pt for the image tower): "
              f"embed_audio against the trainer's eval features, min cosine {cos.min():.6f}")
        if got.shape != x2.shape or cos.min() < COS_MIN:
            raise AssertionError(f"engine embeddings disagree with the trainer's: {cos.min()}")
        del eng

        # (b) run B: resumed from A's step 6, bitwise A at step 8
        b = _loop_trainer(torch, root, run, "model_file=00000006", "running.save_epoch=False",
                          "running.eval_name=")
        if b.global_step != 6:
            raise AssertionError(f"run B resumed at step {b.global_step}, not 6")
        b.learn()
        diff, what = _resume_diff(torch, b, want)
        print(f"(b) run B (resumed from step 6) against run A at step 8: {what}, {len(diff)} not "
              f"bitwise equal")
        if diff or b.global_step != 8:
            worst = sorted(diff.items(), key=lambda kv: -kv[1])[:5]
            raise AssertionError(f"resume is not bitwise: largest differences {worst}")
        del b, want

        # (g) the pinned copy on the side stream against the races it guards
        from vipant_tpu_torch.config import compose

        cfg = compose(FLAGSHIP + [f"running.data_root={root}", f"running.batch_size={LOOP_B}",
                                  "loader_backend=thread", f"num_proc={workers}"])
        batches = [{k: b[k] for k in ("image", "audio")} for b in itertools.islice(
            build_image_audio_dataloader(cfg, "npz_train", True), RACE_BATCHES)]
        found = _race_check(torch, PinnedDevicePut, batches)
        print(f"(g) {len(batches)} loader batches through pinned memory, each copy held back "
              f"{RACE_COPY_MS} ms on the side stream, each read on the compute stream at once and after "
              f"{RACE_READ_MS} ms, its tensors dropped before the next copy; batches whose (early, late) "
              f"reads differ from the host's, for the put and for one without wait_event, one without "
              f"record_stream: " + ", ".join(f"{k} {v}" for k, v in found.items()))
        if (found["Delayed"] != (0, 0) or found["NoWaitEvent"][0] == 0
                or found["NoRecordStream"][1] == 0):
            raise AssertionError("the pinned copy races on the card, or the check cannot see a "
                                 f"missing wait_event or record_stream: {found}")
        del batches

        # (f) the loop's time in its steady state: wav and npz sources, beside the step alone
        print(f"(f) {smi}; host cpu_count {os.cpu_count()}, {workers} loader workers, batch {LOOP_B}, "
              f"SpecAugment on, the loss read every step")
        for index, repeat in (("train", LOOP_WAV_REPEAT), ("npz_train", LOOP_NPZ_REPEAT)):
            with open(os.path.join(root, f"{index}.jsonl")) as f, \
                    open(os.path.join(root, f"{index}_long.jsonl"), "w") as g:
                g.writelines(f.readlines() * repeat)
        prof_dir, n_npz = os.path.join(root, "prof"), LOOP_TRAIN * LOOP_NPZ_REPEAT // LOOP_B
        for source, label in (("train_long", "wav"), ("npz_train_long", "npz")):
            # the npz run's second epoch (its last 12 steps) holds a profiler window of its
            # steps 3 to 5, while the workers still have items to make
            tr = _loop_trainer(torch, root, os.path.join(root, source), f"running.data_name={source}",
                               "running.eval_name=", "running.save_epoch=False",
                               "running.save_rate=1000000000", "profile.alive=True",
                               f"profile.dir={prof_dir}", f"profile.start_step={n_npz + 3}",
                               "profile.num_steps=2")
            tail = 2 * tr.loader.prefetch + 2 if label == "npz" else 0  # wav: the loader is behind
            ms, clips, share, steps, series = _timed_epoch(torch, tr, 0, tail)
            print(f"(f) {label} source, each step's (wait for the batch, train_step call) ms: {series}")
            if label == "npz":
                tr.loader.set_epoch(1, start_batch=n_npz - 12)
                tr.epoch(1)
                span, busy, threads = _trace_window(
                    os.path.join(prof_dir, f"trace_{n_npz + 5:08d}.json"))
                print(f"(f) npz source, a torch.profiler window of its steps {n_npz + 3} to "
                      f"{n_npz + 5}: span {span:.2f} ms, the card busy {busy:.2f} ms (idle "
                      f"{100 * (1 - busy / span):.1f} %); host threads' time inside torch ops "
                      f"(merged): " + "; ".join(f"{t:.2f} ms in {n} ops" for t, n in threads[:4]))
            args = tr.device_put.wait(next(iter(tr.loader)))
            tr.close()
            alone = cuda_ms(torch, lambda: tr.train_step(*args), 5, 2)
            step6 = results.get("_va_step_ms")
            results.setdefault("_loop_windows", {})[label] = (ms, clips, share)
            print(f"(f) {label} source, a window of {steps} steps (arrivals 1 to {steps + 1} of "
                  f"{len(series)}): {ms:.2f} ms per step of the loop, {clips:.1f} clips/s, data-wait "
                  f"share {100 * share:.1f} %; the step alone on a loader batch {alone:.2f} ms "
                  f"({LOOP_B / alone * 1e3:.1f} clips/s); phase 6's step alone at B=64 "
                  f"{'%.2f ms' % step6 if step6 else 'not run'}; {smi}")
            del tr, args
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 15: AT fine-tuning (LAMonitor) on a synthetic Clotho index
LA_TRAIN, LA_EVAL, LA_TEST, LA_SECONDS = 200, 50, 50, 20.0
LA_LONG_REPEAT = 3  # (g)'s index: the train split read 3 times, 12 steps of 50
LA_WORDS = ("a dog barks loudly while rain falls on the metal roof and a car passes by slowly near "
            "birds singing in trees people talk in a crowded room footsteps on gravel wind blows "
            "through leaves water drips into a bucket an engine starts door creaks open").split()
REPORT_NUMBER = re.compile(r"= (\S+)|R@\d+ (\S+)|MED (\S+)|AVG (\S+)")


def write_synthetic_clotho(root, name, n, seconds=LA_SECONDS, seed=0, captions=5):
    """A seeded synthetic Clotho split in the layout of the JAX package's test
    fabrication (``tests/data_synth.py:make_synth_clotho``):
    ``{root}/{name}/aclip/{id}.wav`` (16 kHz mono, a tone per clip plus noise)
    and ``{root}/{name}.csv`` (``file_name, caption_1..caption_5``) with
    ``captions`` distinct captions of 6 to 14 seeded words a clip."""
    import os

    from vipant_tpu_torch.data import write_wav

    sr = 16000
    os.makedirs(os.path.join(root, name, "aclip"), exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rows = ["file_name," + ",".join(f"caption_{i}" for i in range(1, captions + 1))]
    for i in range(n):
        wav = 0.4 * np.sin(2 * np.pi * (180 + 9 * i) * t) + 0.01 * rng.standard_normal(len(t))
        write_wav(os.path.join(root, name, "aclip", f"{name}{i}.wav"), wav.astype(np.float32), sr)
        caps = set()
        while len(caps) < captions:
            caps.add(" ".join(rng.choice(LA_WORDS, int(rng.integers(6, 15)))))
        rows.append(f"{name}{i}.wav," + ",".join(sorted(caps)))
    with open(os.path.join(root, f"{name}.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def _la_monitor(torch, *extra, **kw):
    from vipant_tpu_torch.train import build_monitor

    torch.cuda.empty_cache()
    return build_monitor(LA_FULL + [f"running.batch_size={LA_B}", *extra], **kw)  # on the card


def _la_batch(tr, rng, B):
    """(fbank, int32 token ids laid out as the tokenizer lays them out)."""
    fbank, ids = _caption_batch(tr, rng, B)
    return fbank, ids.int()


def _logged_reports(out_dir):
    """Each save's path and the report the run logged just after it."""
    import os

    with open(os.path.join(out_dir, "train_0.out")) as f:
        lines = [line.rstrip("\n").split(": ", 1)[-1] for line in f]
    return [(m.group(1), lines[i + 1]) for i, line in enumerate(lines)
            if (m := re.match(r"saving the checkpoint to (\S+)$", line)) and i + 1 < len(lines)]


def _report_finite(report):
    """Every number of a 1-vs-k or caption report, which must all be finite."""
    nums = [float(next(g for g in m.groups() if g is not None)) for m in REPORT_NUMBER.finditer(report)]
    if len(nums) < 6 or not np.isfinite(nums).all():
        raise AssertionError(f"report is not finite: {report}")
    return nums


def la_phase(torch, results):
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.data.device_put import PinnedDevicePut
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.train import LATrainer, loss_and_grads

    smi = _smi()
    # (a) one init and batch at B = 50: kernels against the plain ops and against fp32
    tr = _la_monitor(torch, steps_per_epoch=STEPS_PER_EPOCH)
    audio_layers, text_layers = len(tr.model.audio.encoder.resblocks), len(tr.model.text.encoder.resblocks)
    print(f"AT step: {type(tr).__name__}, audio tower {audio_layers} layers trainable, text tower "
          f"{text_layers} layers frozen; {sum(p.numel() for p in tr.trainable.values()):,} trainable / "
          f"{sum(p.numel() for p in tr.frozen.values()):,} frozen params")
    if not isinstance(tr, LATrainer) or any(k.startswith("text.") for k in tr.trainable):
        raise AssertionError("LAMonitor did not build an LATrainer with a frozen text tower")
    batch = _la_batch(tr, np.random.default_rng(0), LA_B)
    k_run = loss_and_grads(tr.state, *batch)
    with plain_ops():
        p_run = loss_and_grads(tr.state, *batch)
        ref = _la_monitor(torch, "compute_dtype=float32", steps_per_epoch=STEPS_PER_EPOCH)
        f_run = loss_and_grads(ref.state, *batch)
    del ref
    hold_grads_to_fp32(torch, f"(a) B={LA_B}", "AT", k_run, p_run, f_run)
    del k_run, p_run, f_run
    reset_launches()
    tr.train_step(*batch)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    fwd_blocks, bwd_blocks = audio_layers + text_layers, audio_layers  # no backward in the text tower
    want = {
        "fused_ln_attention_block": fwd_blocks, "fused_ln_mlp_block": fwd_blocks,
        "fused_ln_attention_block_bwd": bwd_blocks, "fused_ln_mlp_block_bwd": bwd_blocks,
        "layernorm_fwd": 2 * fwd_blocks + 2 * bwd_blocks, "gemm_bias_act": 4 * fwd_blocks + bwd_blocks,
        "attention_fwd": fwd_blocks, "attention_bwd": bwd_blocks, "layernorm_bwd": 2 * bwd_blocks,
        "colsum": 4 * bwd_blocks, "gemm_dgrad": 4 * bwd_blocks, "gemm_wgrad": 4 * bwd_blocks,
        "patch_gather": 1,  # the audio tower
    }
    print(f"(a) launches in one AT step: {json.dumps(counts, sort_keys=True)}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")

    def fwd():
        with torch.no_grad():
            return tr.model(*batch, train=True)

    t = {"fwd": cuda_ms(torch, fwd, 5, 2),
         "fwd_bwd": cuda_ms(torch, lambda: loss_and_grads(tr.state, *batch), 5, 2),
         "step": cuda_ms(torch, lambda: tr.train_step(*batch), 5, 2)}
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(*batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"(a) B={LA_B} kernels: {t['step']:.2f} ms/step ({LA_B / t['step'] * 1e3:.1f} clips/s): fwd "
          f"{t['fwd']:.2f}, fwd+bwd {t['fwd_bwd']:.2f}, optimizer and the rest "
          f"{t['step'] - t['fwd_bwd']:.2f} ms; peak device memory {peak:.2f} GiB; {smi}")
    del tr, batch

    root = tempfile.mkdtemp(prefix="vipant_la_")
    workers = min(8, os.cpu_count() or 1)
    try:
        t0 = time.perf_counter()
        for name, n, seed in (("clotho_train", LA_TRAIN, 0), ("clotho_val", LA_EVAL, 1),
                              ("clotho_test", LA_TEST, 2)):
            write_synthetic_clotho(root, name, n, seed=seed)
        print(f"synthetic Clotho index: {LA_TRAIN} train, {LA_EVAL} eval, {LA_TEST} test clips of "
              f"{LA_SECONDS:.0f} s 16 kHz wav, 5 distinct captions each, written in "
              f"{time.perf_counter() - t0:.1f} s")
        run = os.path.join(root, "run")

        def loop(name, *extra):
            return _la_monitor(torch, f"running.data_root={root}", "running.data_name=clotho_train",
                               "running.eval_name=clotho_val", "running.test_name=clotho_test",
                               "running.epochs=2", "loader_backend=process", f"num_proc={workers}",
                               "running.peep_rate=1", "running.save_rate=6", f"alias_root={run}",
                               f"model_root={run}", f"model_name={name}", "eval=False",
                               "metrics_jsonl=True", *extra)

        # (b) run A at the default CE bound: the save at step 6 is gated on its loss
        a = loop("gate", "running.save_epoch=False")
        t0 = time.perf_counter()
        a.learn()
        torch.cuda.synchronize()
        loss6 = _loop_losses(a)[5]
        with open(os.path.join(a.out_dir, "train_0.out")) as f:
            text = f.read()
        skipped = text.count("save-time eval skipped: loss")
        evals = sum(1 for line in text.splitlines() if ": A->T:" in line)
        print(f"(b) run A (running.eval_loss_bound 5): {a.global_step} steps in "
              f"{time.perf_counter() - t0:.1f} s, losses {[round(v, 4) for v in _loop_losses(a)]}; at step 6 "
              f"loss {loss6:.4f}: {skipped} save-time eval skipped and logged, {evals} evaluated; "
              f"{text.count('TEST A->T')} TEST report")
        if not (skipped == int(loss6 >= 5) and evals == int(loss6 < 5) and "TEST A->T" in text):
            raise AssertionError("the CE gate did not skip exactly when the loss was >= 5, or no TEST")
        del a

        # (b) run B: running.eval_loss_bound=inf, saves and evals at 4, 6 and 8; its launches counted
        b = loop("la", "running.eval_loss_bound=inf", "running.save_epoch=True")
        t0 = time.perf_counter()
        reset_launches()
        b.learn()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        record_launches(results, "la_loop", counts)
        logged = _logged_reports(b.out_dir)
        with open(os.path.join(b.out_dir, "train_0.out")) as f:
            tests = [line.split("TEST ", 1)[1].strip() for line in f if "TEST A->T" in line]
        print(f"(b) run B (bound inf): {b.global_step} steps, 3 saves with an eval and a TEST each and "
              f"a TEST at the end, in {time.perf_counter() - t0:.1f} s; launches {json.dumps(counts, sort_keys=True)}")
        for path, report in logged:
            print(f"    {os.path.basename(path)}: {report}")
        print(f"    TEST at the end: {tests[-1]}")
        if [os.path.basename(p) for p, _ in logged] != ["00000004", "00000006", "00000008"] or len(tests) != 4:
            raise AssertionError(f"run B: saves {logged}, {len(tests)} TEST reports")
        for _, report in logged:
            if not report.startswith("A->T:") or f"@ {LA_EVAL} |" not in report:
                raise AssertionError(f"run B's report is not one of {LA_EVAL} eval clips: {report}")
            _report_finite(report)
        _report_finite(tests[-1])

        # (f) each eval clip's caption embeddings against the plain ops' of the same captions
        emb_root = b.encode_text(out_root=os.path.join(root, "emb"))
        files = sorted(os.listdir(emb_root))
        worst, ds = 1.0, b.evalloader.dataset
        with plain_ops(), torch.no_grad():
            for rec in ds.records:  # each clip's caption ids as the eval items carry them
                ids = np.stack([ds._pad(c) for c in rec["captions_bpe"]])
                want = b.model.encode_text(b.make_batch(ids)[0]).float().cpu().numpy()
                got = np.load(os.path.join(emb_root, f"{rec['id']}.npz"))["v"]
                if got.shape != want.shape:
                    raise AssertionError(f"{rec['id']}.npz holds {got.shape}, not {want.shape}")
                worst = min(worst, float(_row_cos(got, want).min()))
        print(f"(f) encode_text: {len(files)} files of 5 caption embeddings; min cosine to the plain "
              f"ops' {worst:.6f}")
        if len(files) != LA_EVAL or worst < COS_MIN:
            raise AssertionError(f"encode_text: {len(files)} files, min cosine {worst}")
        want = _snapshot(b)
        b.close()
        del b

        # (c) repeated eval of the step directories run B's log names
        t0 = time.perf_counter()
        reports = loop("la", "eval=True", "model_file=train_0.out").learn()
        same = [r == f"{p}: {want}" for r, (p, want) in zip(reports, logged)]
        print(f"(c) repeated eval over run B's train_0.out: {len(reports)} reports in "
              f"{time.perf_counter() - t0:.1f} s; equal to the run's, string for string: {same}")
        if len(reports) != 3 or not same[-1]:
            raise AssertionError(f"repeated eval: {reports} against {logged}")

        # (d) a fresh LATrainer resumed from run B's step 6, bitwise run B at step 8
        c = loop("la", "model_file=00000006", "running.eval_name=", "running.test_name=",
                 "running.save_epoch=False", "running.save_rate=1000000000")
        if c.global_step != 6:
            raise AssertionError(f"resumed at step {c.global_step}, not 6")
        c.learn()
        diff, what = _resume_diff(torch, c, want)
        print(f"(d) resumed from step 6 against run B at step 8: {what}, {len(diff)} not bitwise equal")
        if diff or c.global_step != 8:
            raise AssertionError(f"AT resume is not bitwise: {sorted(diff.items(), key=lambda kv: -kv[1])[:5]}")
        del c, want

        # (e) the captioning variant: 2 steps of learn(), then caption_report on the eval clips
        os.symlink(os.path.join(root, "clotho_train"), os.path.join(root, "clotho_cap"))
        with open(os.path.join(root, "clotho_train.csv")) as f:
            head = f.readlines()[:1 + 2 * LA_B]
        with open(os.path.join(root, "clotho_cap.csv"), "w") as f:
            f.writelines(head)
        torch.cuda.empty_cache()
        from vipant_tpu_torch.train import build_monitor

        cap = build_monitor(CAPTION_FULL + [
            "monitor=LAMonitor", f"running.batch_size={LA_B}", f"running.data_root={root}",
            "running.data_name=clotho_cap", "running.eval_name=clotho_val", "running.test_name=",
            "running.epochs=1", "loader_backend=process", f"num_proc={workers}", "running.peep_rate=1",
            "running.save_rate=1000000000", f"alias_root={run}", f"model_root={run}", "model_name=cap",
            "eval=False", "metrics_jsonl=True"])
        t0 = time.perf_counter()
        cap.learn()
        losses = _loop_losses(cap)
        t1 = time.perf_counter()
        report = cap.caption_report(cap.evalloader)
        cap.close()
        print(f"(e) captioning LATrainer: LM losses {[round(v, 4) for v in losses]} in {t1 - t0:.1f} s; "
              f"caption_report (greedy, {cap.model.decoder.max_len_dec} decode steps) in "
              f"{time.perf_counter() - t1:.1f} s: {report[:400]}")
        if len(losses) != 2 or not np.isfinite(losses).all() or f"@ {LA_EVAL} |" not in report:
            raise AssertionError(f"captioning: losses {losses}, report {report}")
        _report_finite(report.split(" | ")[0])
        del cap

        # (g) the loop's steady window: one epoch of the train split read LA_LONG_REPEAT times
        os.symlink(os.path.join(root, "clotho_train"), os.path.join(root, "clotho_train_long"))
        with open(os.path.join(root, "clotho_train.csv")) as f:
            header, *rows = f.readlines()
        with open(os.path.join(root, "clotho_train_long.csv"), "w") as f:
            f.writelines([header] + rows * LA_LONG_REPEAT)
        w = loop("window", "running.data_name=clotho_train_long", "running.eval_name=",
                 "running.test_name=", "running.epochs=1", "running.save_epoch=False",
                 "running.save_rate=1000000000")
        head = w.loader.prefetch + 1  # batches in flight from the start, made alongside the first
        ms, clips, share, steps, series = _timed_epoch(torch, w, 0, head=head)
        print(f"(g) {smi}; host cpu_count {os.cpu_count()}, {workers} loader workers, batch {LA_B}, "
              f"SpecAugment on, the loss read every step; the train split read {LA_LONG_REPEAT} times, "
              f"one epoch, each step's (wait for the batch, train_step call) ms: {series}; its window "
              f"from arrival {head + 1} to {head + steps + 1} of {len(series)} ({steps} steps, the "
              f"{head} batches made alongside the first left out): {ms:.2f} ms per step of the loop, "
              f"{clips:.1f} clips/s, data-wait share {100 * share:.1f} %; (a)'s step alone "
              f"{t['step']:.2f} ms ({LA_B / t['step'] * 1e3:.1f} clips/s)")

        # (h) the pinned copy of int32 token ids against the races it guards, on host batches
        # from the window's workers
        w.loader.device_put_fn = None
        batches = [{k: b[k] for k in ("audio", "text")} for b in itertools.islice(w.loader, RACE_BATCHES)]
        w.close()
        del w
        found = _race_check(torch, PinnedDevicePut, batches)
        print(f"(h) {len(batches)} AT loader batches (fbank fp32, token ids {batches[0]['text'].dtype}) "
              f"through pinned memory, held back and read twice as in phase 14 (g): (early, late) reads "
              f"differing, the put, without wait_event, without record_stream: "
              + ", ".join(f"{k} {v}" for k, v in found.items()))
        if (found["Delayed"] != (0, 0) or found["NoWaitEvent"][0] == 0
                or found["NoRecordStream"][1] == 0):
            raise AssertionError(f"the pinned copy of the AT batches races, or the check is blind: {found}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 16: the device frontend (fbank, SpecAugment, shipping formats) and serving from files
DEV_SHIP = ["running.audio.on_device=True", "running.audio.wav_int16=True", "running.image_uint8=True"]
LOOP_DEV_REPEAT = 4  # (c)'s timed index: the train split read 4 times, 16 steps
FBANK_TOL = {"rfft": 2e-3, "dft": 5e-3}  # max |d| of the log-mel against fbank_np (the JAX tests' bounds)
SCORE_TOL = 0.09  # zero-shot scores: |a.t - a'.t'| <= |a - a'| + |t - t'|, each <= sqrt(2 (1 - COS_MIN))
SERVE_FILES = 6


def _clip_batch(B, seconds, seed=0):
    """B seeded tone-plus-noise clips [B, N] fp32, as write_synthetic_va's."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * 16000))) / 16000
    return np.stack([(0.4 * np.sin(2 * np.pi * (200 + 7 * i) * t)
                      + 0.01 * rng.standard_normal(len(t))).astype(np.float32) for i in range(B)])


def _post_json(url, data, ctype="application/json"):
    import urllib.request

    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def frontend_phase(torch, results):
    import base64
    import glob
    import os
    import shutil
    import tempfile
    import threading
    import urllib.request

    from vipant_tpu_torch.config import compose
    from vipant_tpu_torch.data import build_image_audio_dataloader
    from vipant_tpu_torch.data.device_put import PinnedDevicePut
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.ops.fbank import fbank
    from vipant_tpu_torch.ops.fbank_np import FbankParams, fbank as fbank_np
    from vipant_tpu_torch.ops.specaugment import axis_uniforms, freq_mask, time_mask
    from vipant_tpu_torch.serve import InferenceEngine, main as serve_main, make_server

    smi = _smi()
    # (a) the fbank on the card: a B64 batch of 10.05 s clips against the NumPy Kaldi fbank
    wav = _clip_batch(LOOP_B, 10.05)
    host = np.stack([fbank_np(w) for w in wav])
    wav_d = torch.from_numpy(wav).cuda()
    print(f"(a) TF32 in this process: matmul {torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
          f"precision {torch.get_float32_matmul_precision()!r}; a batch of {LOOP_B} x {wav.shape[1]} "
          f"samples, {host.shape[1]} frames")
    for route in ("rfft", "dft"):
        fn = lambda: fbank(wav_d, FbankParams(), use_dft=route == "dft")
        got = fn()
        torch.cuda.synchronize()
        err = float(np.abs(got.cpu().numpy() - host).max())
        us = device_us(torch, fn)
        print(f"(a) fbank {route}: max |d| against fbank_np {err:.3e} (bound {FBANK_TOL[route]}); "
              f"device_us {'not measured' if us is None else '%.1f' % us}; loop {cuda_ms(torch, fn, 10, 2):.3f} ms")
        if got.shape != host.shape or not err < FBANK_TOL[route]:
            raise AssertionError(f"the device fbank ({route}) disagrees with fbank_np: {err}")
    del got, wav_d

    # (b) SpecAugment on the card: bitwise the CPU's for the same uniforms
    feats = torch.from_numpy(host[:, :1000]).contiguous()
    u = [axis_uniforms(torch.Generator().manual_seed(s), LOOP_B) for s in (1, 2)]
    on_cpu = time_mask(freq_mask(feats, 32, u[0]), 200, u[1])
    on_card = time_mask(freq_mask(feats.cuda(), 32, tuple(x.cuda() for x in u[0])), 200,
                        tuple(x.cuda() for x in u[1]))
    masked = float((on_cpu != feats).float().mean())
    print(f"(b) SpecAugment (32, 200) on [{LOOP_B}, 1000, 128]: card bitwise the CPU "
          f"{torch.equal(on_card.cpu(), on_cpu)}, {100 * masked:.1f} % of the values masked")
    if not torch.equal(on_card.cpu(), on_cpu) or masked == 0:
        raise AssertionError("SpecAugment on the card differs from the CPU's, or masks nothing")
    del feats, on_cpu, on_card

    root = tempfile.mkdtemp(prefix="vipant_frontend_")
    workers = min(8, os.cpu_count() or 1)
    try:
        t0 = time.perf_counter()
        write_synthetic_va(root, "train", LOOP_TRAIN, npz_name="npz_train", seed=0)
        write_synthetic_va(root, "val", LOOP_EVAL, seed=1)
        print(f"synthetic index ({LOOP_TRAIN} + {LOOP_EVAL} clips of {LOOP_SECONDS:.0f} s, JPEG frames, "
              f"the npz twin) written in {time.perf_counter() - t0:.1f} s")

        # (c) the VA loop on the device frontend: int16 waveforms and uint8 frames ship
        run = os.path.join(root, "run")
        a = _loop_trainer(torch, root, run, *DEV_SHIP, "running.save_epoch=False")
        if not (a.on_device_audio and a.image_uint8):
            raise AssertionError("the trainer did not take the device frontend")
        init = {k: p.detach().clone() for k, p in a.trainable.items() if k.startswith("audio.")}
        moved, apply = {}, a.state.optimizer.apply

        def apply_and_look(grads):
            out = apply(grads)
            if a.state.optimizer.count == 2:
                moved.update({k: not torch.equal(a.trainable[k], p) for k, p in init.items()})
            return out

        a.state.optimizer.apply = apply_and_look
        t0 = time.perf_counter()
        reset_launches()
        a.learn()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        record_launches(results, "va_loop_dev", counts)
        losses = _loop_losses(a)
        print(f"(c) {a.global_step} steps (2 epochs of {a.steps_per_epoch}) and an eval at step 6 on the "
              f"device frontend in {time.perf_counter() - t0:.1f} s; losses {[round(v, 5) for v in losses]}; "
              f"{sum(moved.values())} of {len(moved)} audio params moved by step 2; launches "
              f"{json.dumps(counts, sort_keys=True)}")
        if len(losses) != 8 or not np.isfinite(losses).all() or not any(moved.values()):
            raise AssertionError("the device-frontend loop: non-finite loss, missing steps, or the "
                                 "audio tower did not move")
        want = _snapshot(a)
        del a, init
        torch.cuda.empty_cache()

        # (g) resumed from step 6 on the device frontend (SpecAugment draws from the train state's
        # generator): bitwise the run at step 8
        b = _loop_trainer(torch, root, run, *DEV_SHIP, "model_file=00000006", "running.save_epoch=False",
                          "running.eval_name=")
        if b.global_step != 6:
            raise AssertionError(f"the device-frontend run resumed at step {b.global_step}, not 6")
        b.learn()
        diff, what = _resume_diff(torch, b, want)
        print(f"(g) resumed from step 6 on the device frontend against the run at step 8: {what}, "
              f"{len(diff)} not bitwise equal")
        if diff or b.global_step != 8:
            raise AssertionError("the device-frontend resume is not bitwise: "
                                 f"{sorted(diff.items(), key=lambda kv: -kv[1])[:5]}")
        del b, want
        torch.cuda.empty_cache()

        # (c) its steady window over the train split read LOOP_DEV_REPEAT times, a profiled epoch after
        with open(os.path.join(root, "train.jsonl")) as f, \
                open(os.path.join(root, "train_long.jsonl"), "w") as g:
            g.writelines(f.readlines() * LOOP_DEV_REPEAT)
        n = LOOP_TRAIN * LOOP_DEV_REPEAT // LOOP_B
        prof_dir = os.path.join(root, "prof")
        tr = _loop_trainer(torch, root, os.path.join(root, "long"), *DEV_SHIP,
                           "running.data_name=train_long", "running.eval_name=",
                           "running.save_epoch=False", "running.save_rate=1000000000",
                           "profile.alive=True", f"profile.dir={prof_dir}",
                           f"profile.start_step={n + 3}", "profile.num_steps=2")
        tail = 2 * tr.loader.prefetch + 2
        ms, clips, share, steps, series = _timed_epoch(torch, tr, 0, tail)
        print(f"(c) each step's (wait for the batch, train_step call) ms: {series}")
        tr.loader.set_epoch(1)
        tr.epoch(1)
        span, busy, threads = _trace_window(os.path.join(prof_dir, f"trace_{n + 5:08d}.json"))
        batch = next(iter(tr.loader))
        shipped = sum(batch[k].numel() * batch[k].element_size() for k in ("image", "audio"))
        alen = batch["audio_len"]
        args = tr.device_put.wait(batch)
        tr.close()
        alone = cuda_ms(torch, lambda: tr.train_step(*args, audio_len=alen), 5, 2)
        fp32_bytes = LOOP_B * (3 * 224 * 224 + 1000 * 128) * 4
        wav_window = results.get("_loop_windows", {}).get("wav")
        step6 = results.get("_va_step_ms")
        print(f"(c) device frontend, a window of {steps} steps: {ms:.2f} ms per step of the loop, "
              f"{clips:.1f} clips/s, data-wait share {100 * share:.1f} %; the card idle "
              f"{100 * (1 - busy / span):.1f} % of a profiled window of steps {n + 3} to {n + 5} "
              f"(span {span:.2f} ms, busy {busy:.2f} ms); bytes shipped per batch {shipped / 1e6:.2f} MB "
              f"(int16 waveforms + uint8 frames; fp32 fbanks + fp32 frames: {fp32_bytes / 1e6:.2f} MB); "
              f"the step alone with its frontend {alone:.2f} ms; phase 14's wav-source window "
              + ("%.2f ms per step, %.1f clips/s, data-wait %.1f %%" % (wav_window[0], wav_window[1],
                                                                       100 * wav_window[2])
                 if wav_window else "not run")
              + f"; phase 6's step alone {'%.2f ms' % step6 if step6 else 'not run'}; {smi}")
        # the frontend's own device time on this batch: waveform -> normalised fbank + SpecAugment
        wav16 = args[1]
        fe_us = device_us(torch, lambda: tr._frontend_audio(wav16, True, alen))
        print(f"(c) the audio frontend alone on a B{LOOP_B} int16 batch (rescale, fbank, pad, "
              f"SpecAugment): device_us {'not measured' if fe_us is None else '%.1f' % fe_us}")
        del tr, args, batch
        torch.cuda.empty_cache()

        # (d) the npz split shipping bf16 and int16 fbanks: the device batch against the fp32 one
        def device_batch(*extra):
            cfg = compose(FLAGSHIP + [f"running.data_root={root}", f"running.batch_size={LOOP_B}",
                                      "loader_backend=thread", f"num_proc={workers}", *extra])
            put = PinnedDevicePut(("image", "audio"))
            loader = build_image_audio_dataloader(cfg, "npz_train", False, device_put_fn=put)
            batch = next(iter(loader))
            return put.wait(batch)

        ref = device_batch()
        for fmt in ("ship_bf16", "ship_int16"):
            flags = [f"running.audio.{fmt}=True"]
            args = device_batch(*flags)
            tr = _trainer(torch, LOOP_B, *flags)
            got = tr._frontend_audio(args[1], False)
            if fmt == "ship_bf16":
                ok = args[1].dtype == torch.uint16 and torch.equal(got, ref[1].to(torch.bfloat16).float())
                err = float((got - ref[1]).abs().max())
            else:
                err = float((got - ref[1]).abs().max())
                ok = args[1].dtype == torch.int16 and err <= 0.5 / 256
            loss = float(tr.train_step(*args)["loss"])
            print(f"(d) npz {fmt}: ships {args[1].dtype} {tuple(args[1].shape)} "
                  f"({args[1].numel() * args[1].element_size() / 1e6:.2f} MB against "
                  f"{ref[1].numel() * 4 / 1e6:.2f} MB fp32); on the card against the fp32 batch max |d| "
                  f"{err:.3e} ({'bitwise its bf16 rounding' if fmt == 'ship_bf16' else 'bound 0.5/256'}): "
                  f"{ok}; one training step, loss {loss:.5f}")
            if not ok or not np.isfinite(loss):
                raise AssertionError(f"npz {fmt}: the device batch disagrees, or the step failed")
            del tr, args, got
            torch.cuda.empty_cache()
        del ref

        # (e) the engine from files on the card against a CPU engine (plain ops, fp32), same weights
        wavs = sorted(glob.glob(os.path.join(root, "aclip", "val*.wav")))[:SERVE_FILES]
        jpgs = sorted(glob.glob(os.path.join(root, "frame", "val*.jpg")))[:SERVE_FILES]
        engines = {}
        for kind, cfg in (("clap", CLAP_FULL), ("caption", CAPTION_FULL), ("image", FLAGSHIP)):
            card = InferenceEngine(cfg, batch_size=BATCH, seed=0)
            cpu = InferenceEngine(cfg + ["compute_dtype=float32"], batch_size=BATCH, device="cpu")
            cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
            engines[kind] = (card, cpu)
        classes = {c: [f"the sound of {c}"] for c in CLASSES}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = {"audio": engines["clap"][0].embed_audio_files(wavs),
               "image": engines["image"][0].embed_image_files(jpgs),
               "zero_shot": engines["clap"][0].zero_shot(engines["clap"][0].fbank_files(wavs), classes),
               "captions": engines["caption"][0].caption_files(wavs)}
        # the serving command line on the same files, bf16 and int8: its engine is seeded as the one above
        clips = os.path.join(root, "clips")
        os.makedirs(clips)
        for w in wavs:
            os.link(w, os.path.join(clips, os.path.basename(w)))
        cli = {}
        for quantize in ("", "int8"):
            npz = os.path.join(root, f"cli{quantize}.npz")
            serve_main(["--task", "embed_audio", "--inputs", os.path.join(clips, "*.wav"), "--output", npz,
                        "--batch_size", str(BATCH), "--quantize", quantize, "--", *CLAP_FULL])
            cli[quantize or "bf16"] = np.load(npz)["embeddings"]
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        record_launches(results, "serve_files", counts)
        print(f"(e) on the card: embed_audio_files, embed_image_files, zero_shot and caption_files "
              f"(greedy) of {len(wavs)} files at batch {BATCH}, then `python -m vipant_tpu_torch.serve "
              f"--task embed_audio` on them in bf16 and int8, in {time.perf_counter() - t0:.2f} s; "
              f"launches {json.dumps(counts, sort_keys=True)}")
        cli_cos = float(_row_cos(cli["int8"], cli["bf16"]).min())
        print(f"(e) the command line: bf16 embeddings bitwise the engine's "
              f"{np.array_equal(cli['bf16'], out['audio'])}; int8 against bf16 min row cosine {cli_cos:.6f}")
        if not np.array_equal(cli["bf16"], out["audio"]) or cli_cos < 0.99:
            raise AssertionError(f"the serving command line disagrees with the engine: int8 cosine {cli_cos}")
        want = {"audio": engines["clap"][1].embed_audio_files(wavs),
                "image": engines["image"][1].embed_image_files(jpgs),
                "zero_shot": engines["clap"][1].zero_shot(engines["clap"][1].fbank_files(wavs), classes),
                "captions": engines["caption"][1].caption_files(wavs)}
        fb = engines["caption"][0].fbank_files(wavs[:BATCH])
        with torch.inference_mode():
            first = [e.model.decode(torch.from_numpy(fb[:, None]).to(e.device))[1][:, 0].float().cpu().numpy()
                     for e in engines["caption"]]
        cos = {k: float(_row_cos(out[k], want[k]).min()) for k in ("audio", "image")}
        cos["caption first-step logits"] = float(_row_cos(*first).min())
        score_err = float(np.abs(out["zero_shot"]["scores"] - want["zero_shot"]["scores"]).max())
        same_pred = sum(a == b for a, b in zip(out["zero_shot"]["prediction"], want["zero_shot"]["prediction"]))
        same_caps = sum(a == b for a, b in zip(out["captions"], want["captions"]))
        print(f"(e) against the CPU engine (plain ops, fp32): min row cosine {cos}; zero-shot scores max "
              f"|d| {score_err:.3e} (bound {SCORE_TOL}), {same_pred} of {len(wavs)} predictions equal; "
              f"{same_caps} of {len(wavs)} greedy captions string-equal; e.g. {out['captions'][0]!r}")
        if min(cos.values()) < COS_MIN or score_err > SCORE_TOL or len(out["captions"]) != len(wavs):
            raise AssertionError(f"serving from files on the card disagrees with the CPU engine: {cos}, "
                                 f"{score_err}")

        # (f) the HTTP server on the card: one request per route, equal to the engine's own calls
        checks = {}
        for kind in ("clap", "caption", "image"):
            eng = engines[kind][0]
            srv = make_server(eng, port=0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                if kind == "clap":
                    with urllib.request.urlopen(url + "/health", timeout=60) as r:
                        checks["/health"] = json.loads(r.read()) == {"ok": True}
                    _, o = _post_json(url + "/embed_text", json.dumps({"texts": PROMPTS[:2]}).encode())
                    checks["/embed_text"] = np.allclose(o["embeddings"], eng.embed_texts(PROMPTS[:2]),
                                                        atol=1e-6)
                    with open(wavs[0], "rb") as f:
                        _, o = _post_json(url + "/embed_audio", f.read(), "audio/wav")
                    checks["/embed_audio"] = np.allclose(o["embeddings"], out["audio"][:1], atol=1e-6)
                    with open(wavs[1], "rb") as f:
                        b64 = base64.b64encode(f.read()).decode()
                    _, o = _post_json(url + "/zero_shot", json.dumps(
                        {"labels": list(CLASSES), "wav_b64": b64}).encode())
                    zs = eng.zero_shot(eng.fbank_files(wavs[1:2]), classes)
                    checks["/zero_shot"] = (o["prediction"] == zs["prediction"]
                                            and np.allclose(o["scores"], zs["scores"], atol=1e-6))
                elif kind == "caption":
                    with open(wavs[0], "rb") as f:
                        _, o = _post_json(url + "/caption", f.read(), "audio/wav")
                    checks["/caption"] = o["captions"] == out["captions"][:1]
                else:
                    with open(jpgs[0], "rb") as f:
                        b64 = base64.b64encode(f.read()).decode()
                    _, o = _post_json(url + "/embed_image", json.dumps({"images_b64": [b64]}).encode())
                    checks["/embed_image"] = np.allclose(o["embeddings"], out["image"][:1], atol=1e-6)
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(60)
        print(f"(f) the server on the card, each route against the engine's own call: {checks}")
        if not all(checks.values()) or len(checks) != 6:
            raise AssertionError(f"server routes disagree with the engine: {checks}")
        del engines
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 17: checkpoint loading and export
CLIP_NAME = "synthetic-ViT-B32"  # not a zoo name: loaded by the {root}/{name}.pt convention
CKPT_B, CKPT_STEPS = 64, 3
REGRID_TOL = 1e-5  # a re-gridded position grid, one device's bilinear resize against another's
COS_CKPT = 0.9999  # the engine on the trainer's .pth against the trainer's own audio tower
# the port's tower names -> CLIP's (visual and text), written out independently of ckpt/clip_port.py
_CLIP_NAMES = {
    "visual": (("misc.positional_embedding", "positional_embedding"),
               ("misc.class_embedding", "class_embedding"),
               ("pre_encoder.conv1.weight", "conv1.weight"), ("pre_encoder.ln.", "ln_pre."),
               ("encoder.resblocks.", "transformer.resblocks."), ("post_encoder.ln.", "ln_post."),
               ("post_encoder.proj", "proj")),
    "text": (("misc.positional_embedding", "positional_embedding"),
             ("pre_encoder.token_embedding.weight", "token_embedding.weight"),
             ("encoder.resblocks.", "transformer.resblocks."), ("post_encoder.ln.", "ln_final."),
             ("post_encoder.proj", "text_projection")),
}


def _clip_name(name, kind):
    for port, clip in _CLIP_NAMES[kind]:
        if name.startswith(port):
            return ("visual." if kind == "visual" else "") + clip + name[len(port):]
    raise KeyError(name)


def synthetic_clip_state_dict(torch, seed=0, vw=768, tw=512, emb=512, layers=12):
    """A CLIP ViT-B/32 state dict drawn from ``seed`` at CLIP's init
    scales, at full width by default: visual width 768, 12 layers, patch
    32, 50 positions; text width 512, 12 layers, vocabulary 49,408, context
    77; embedding width 512; ``logit_scale`` log(1 / 0.07). fp32, about
    600 MB."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(name, shape, std, mean=0.0):
        sd[name] = torch.randn(shape, generator=g) * std + mean

    def trunk(prefix, width, layers):
        out_std = width ** -0.5 * (2 * layers) ** -0.5
        for i in range(layers):
            b = f"{prefix}transformer.resblocks.{i}."
            normal(b + "attn.in_proj_weight", (3 * width, width), width ** -0.5)
            normal(b + "attn.in_proj_bias", (3 * width,), 0.02)
            normal(b + "attn.out_proj.weight", (width, width), out_std)
            normal(b + "attn.out_proj.bias", (width,), 0.02)
            for ln in ("ln_1", "ln_2"):
                normal(b + ln + ".weight", (width,), 0.02, 1.0)
                normal(b + ln + ".bias", (width,), 0.02)
            normal(b + "mlp.c_fc.weight", (4 * width, width), (2 * width) ** -0.5)
            normal(b + "mlp.c_fc.bias", (4 * width,), 0.02)
            normal(b + "mlp.c_proj.weight", (width, 4 * width), out_std)
            normal(b + "mlp.c_proj.bias", (width,), 0.02)

    normal("visual.class_embedding", (vw,), vw ** -0.5)
    normal("visual.positional_embedding", (50, vw), vw ** -0.5)
    normal("visual.conv1.weight", (vw, 3, 32, 32), (3 * 32 * 32) ** -0.5)
    for ln in ("ln_pre", "ln_post"):
        normal(f"visual.{ln}.weight", (vw,), 0.02, 1.0)
        normal(f"visual.{ln}.bias", (vw,), 0.02)
    trunk("visual.", vw, layers)
    normal("visual.proj", (vw, emb), vw ** -0.5)
    normal("token_embedding.weight", (49408, tw), 0.02)
    normal("positional_embedding", (77, tw), 0.01)
    trunk("", tw, layers)
    normal("ln_final.weight", (tw,), 0.02, 1.0)
    normal("ln_final.bias", (tw,), 0.02)
    normal("text_projection", (tw, emb), tw ** -0.5)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return sd


def _tower_vs_file(torch, tower, sd, kind, skip=()):
    """Names of ``tower``'s params that are not bitwise the file's tensor."""
    return [k for k, p in tower.named_parameters()
            if k not in skip and not torch.equal(p.detach().cpu(), sd[_clip_name(k, kind)])]


def ckpt_phase(torch, results):
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.ops.interp import interp_pos_grid
    from vipant_tpu_torch.serve import InferenceEngine
    from vipant_tpu_torch.train import Trainer

    root = tempfile.mkdtemp(prefix="vipant_ckpt_")
    try:
        # (a) the synthetic full-width CLIP file
        t0 = time.perf_counter()
        sd = synthetic_clip_state_dict(torch)
        clip_root = os.path.join(root, "clip")
        os.makedirs(clip_root)
        path = os.path.join(clip_root, CLIP_NAME + ".pt")
        torch.save(sd, path)
        n = sum(v.numel() for v in sd.values())
        print(f"(a) a seeded CLIP ViT-B/32 state dict, {len(sd)} tensors, {n / 1e6:.1f} M params, "
              f"written as {os.path.getsize(path) / 1e6:.1f} MB in {time.perf_counter() - t0:.1f} s")
        with_clip = [f"running.clip_model_root={clip_root}", f"running.clip_model_name={CLIP_NAME}"]

        # (b) the CLAP engine seeded from it, on the card and on the CPU
        t0 = time.perf_counter()
        eng = InferenceEngine(CLAP_FULL + with_clip, batch_size=CKPT_B)  # on the card
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        pos = "misc.positional_embedding"
        off = {"text": _tower_vs_file(torch, eng.model.text, sd, "text"),
               "audio": _tower_vs_file(torch, eng.model.audio, sd, "visual", skip=(pos,))}
        grid = eng.model.audio.grid
        cpu_pos = interp_pos_grid(sd["visual.positional_embedding"], (7, 7), grid)
        card_pos = interp_pos_grid(sd["visual.positional_embedding"].cuda(), (7, 7), grid).cpu()
        got_pos = eng.model.audio.misc.positional_embedding.detach().cpu()
        pos_err = (float((got_pos - cpu_pos).abs().max()), float((got_pos - card_pos).abs().max()))
        scale_ok = eng.model.loss.logit_scale.item() == sd["logit_scale"].item()
        print(f"(b) the CLAP engine seeded from the file in {built:.1f} s: tensors not bitwise the "
              f"file's {off}; the audio position grid 7x7 -> {grid[0]}x{grid[1]} against a CPU "
              f"retarget max |d| {pos_err[0]:.2e}, against one on the card {pos_err[1]:.2e} "
              f"(bound {REGRID_TOL}); logit_scale the file's: {scale_ok}")
        if any(off.values()) or max(pos_err) > REGRID_TOL or not scale_ok:
            raise AssertionError(f"the engine's towers are not the file's: {off}, {pos_err}, {scale_ok}")
        fb = np.random.default_rng(17).standard_normal((CKPT_B, 1000, 128)).astype(np.float32)
        torch.cuda.synchronize()
        reset_launches()
        a, t = eng.embed_audio(fb), eng.embed_texts(PROMPTS)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        blocks = len(eng.model.audio.encoder.resblocks) + len(eng.model.text.encoder.resblocks)
        want = {"fused_ln_attention_block": blocks, "fused_ln_mlp_block": blocks,
                "layernorm_fwd": 2 * blocks, "gemm_bias_act": 4 * blocks, "attention_fwd": blocks,
                "patch_gather": 1}  # one audio chunk of CKPT_B
        print(f"(b) launches of embed_audio (batch {CKPT_B}) and embed_texts: "
              f"{json.dumps(counts, sort_keys=True)}")
        if counts != want:
            raise AssertionError(f"launch counts {counts} != expected {want}")
        record_launches(results, "ckpt", counts)
        t0 = time.perf_counter()
        cpu = InferenceEngine(CLAP_FULL + with_clip + ["compute_dtype=float32"], batch_size=CKPT_B,
                              device="cpu")
        same = all(torch.equal(p, dict(eng.model.named_parameters())[k].detach().cpu())
                   for k, p in cpu.model.named_parameters())
        ca, ct = cpu.embed_audio(fb), cpu.embed_texts(PROMPTS)
        cos = {"audio": float(_row_cos(a, ca).min()), "text": float(_row_cos(t, ct).min())}
        print(f"(b) against the same engine on the CPU (plain ops, fp32; its weights bitwise the card's: "
              f"{same}; {time.perf_counter() - t0:.1f} s): min row cosine {cos}")
        if not same or min(cos.values()) < COS_MIN or not np.isfinite(a).all():
            raise AssertionError(f"the CLIP-seeded engine on the card disagrees with the CPU's: {cos}")
        del eng, cpu
        torch.cuda.empty_cache()

        # (c) the flagship VA trainer seeded from the same file: three steps, a save with export_pth
        run = os.path.join(root, "run")
        tr = Trainer(FLAGSHIP + with_clip + [f"running.batch_size={CKPT_B // 4}", "export_pth=True",
                                            f"alias_root={run}", "model_name=va"],
                     steps_per_epoch=STEPS_PER_EPOCH)  # on the card
        off = _tower_vs_file(torch, tr.model.image, sd, "visual")
        rng = np.random.default_rng(18)
        losses = [float(tr.train_step(*_va_batch(tr, rng, CKPT_B // 4))["loss"]) for _ in range(CKPT_STEPS)]
        tr.global_step = CKPT_STEPS
        step = tr.save()
        pth = os.path.join(step, f"{CKPT_STEPS:08d}.pth")
        ckpt = torch.load(pth, weights_only=False)
        audio = ckpt["model"][0]
        own = {k[len("audio."):]: p for k, p in tr.trainable.items() if k.startswith("audio.")}
        exported = sorted(audio) == sorted(own) and all(torch.equal(v, own[k].cpu()) for k, v in audio.items())
        print(f"(c) the VA trainer (the frozen image tower's {len(tr.frozen)} tensors, not bitwise the "
              f"file's: {off}): losses {[round(v, 5) for v in losses]}; {os.path.basename(pth)}: a "
              f"{len(ckpt['model'])}-tuple, its audio tower the trainer's: {exported}")
        if off or not np.isfinite(losses).all() or len(ckpt["model"]) != 2 or not exported:
            raise AssertionError("the CLIP-seeded VA trainer or its .pth export failed")
        with torch.no_grad():
            own_feats = tr.model.encode_audio(torch.from_numpy(fb[:, None]).cuda(), train=False)
        own_feats = own_feats.float().cpu().numpy()
        del tr
        torch.cuda.empty_cache()
        eng = InferenceEngine(FLAGSHIP + [f"model_file={pth}"], batch_size=CKPT_B)
        cos = float(_row_cos(eng.embed_audio(fb), own_feats).min())
        print(f"(c) an engine on that .pth: embed_audio against the trainer's audio tower in eval mode, "
              f"min row cosine {cos:.6f} (bound {COS_CKPT})")
        if cos < COS_CKPT:
            raise AssertionError(f"the engine on the exported .pth disagrees with the trainer: {cos}")
        del eng
        torch.cuda.empty_cache()

        # (d) the AT start: LAMonitor from the VA .pth
        mon = _la_monitor(torch, f"model_file={pth}", steps_per_epoch=STEPS_PER_EPOCH)
        loaded = all(torch.equal(mon.trainable["audio." + k].cpu(), v) for k, v in audio.items())
        loss = float(mon.train_step(*_la_batch(mon, rng, LA_B))["loss"])
        print(f"(d) LAMonitor from the VA .pth: its audio tower bitwise the file's {loaded}; one step "
              f"at B = {LA_B}, loss {loss:.5f}")
        if not loaded or not np.isfinite(loss):
            raise AssertionError("LAMonitor did not load the VA .pth, or its step failed")
        del mon
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 18: classification (ESC-50 x-fold and zero-shot, AudioSet multi-label, the classifier engine)
CLF_TOWERS = [  # the towers of CLAP_FULL: ViT-B/32 audio at T = 306, the 12-layer width-512 text tower
    "+model/image=vit_val", "+model/audio=vit_val", "+model/text=transformer_val",
    "+optimizer=standard", "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=1000", "model_file=",
]
ESC_FULL = ["+running=esc50", *CLF_TOWERS, "+model/loss=ce_cls", "worker=ESClassifier",
            "monitor=ESCMonitor"]
AS_FULL = ["+running=audioset", *CLF_TOWERS, "+model/loss=imagine_and_classify", "worker=ASClassifier",
           "monitor=ASMonitor", "running.mixup_rate=0.5", "running.weighted_sampling=True"]
ESC_CLASSES = (  # ESC-50's categories, in the order of its targets
    "dog rooster pig cow frog cat hen insects sheep crow rain sea_waves crackling_fire crickets "
    "chirping_birds water_drops wind pouring_water toilet_flush thunderstorm crying_baby sneezing "
    "clapping breathing coughing footsteps laughing brushing_teeth snoring drinking_sipping "
    "door_wood_knock mouse_click keyboard_typing door_wood_creaks can_opening washing_machine "
    "vacuum_cleaner clock_alarm clock_tick glass_breaking helicopter chainsaw siren car_horn engine "
    "train church_bells airplane fireworks hand_saw").split()
ESC_FOLDS, ESC_SECONDS, ESC_B = 5, 5.0, 50  # ESC-50: 5 folds of 5 s clips; running/esc50.yaml's batch
AS_LABELS, AS_TRAIN, AS_EVAL, AS_B = 527, 128, 64, 64  # AudioSet's label count; running/audioset.yaml's batch
NATIVE_TOL = 2e-3  # the native fbank against fbank_np (float FFT against float64 rfft; ~4e-4 measured)
ENGINE_LABELS = ("dog", "rain", "siren", "church bells", "keyboard typing")


def write_synthetic_esc50(root, per_fold=1, folds=ESC_FOLDS, seconds=ESC_SECONDS, classes=ESC_CLASSES,
                          seed=0):
    """A seeded synthetic ESC-50 tree in the real layout: ``{root}/esc50.csv``
    (``filename, fold, target, category``) and ``{root}/audio/{fold}-{id}-A-{target}.wav``
    (16 kHz mono, a tone per class plus noise), ``per_fold`` clips of each
    class in each of ``folds`` folds."""
    import os

    from vipant_tpu_torch.data import write_wav

    sr = 16000
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rows = ["filename,fold,target,category"]
    for fold in range(1, folds + 1):
        for target, cat in enumerate(classes):
            for j in range(per_fold):
                name = f"{fold}-{100 * target + j}-A-{target}.wav"
                wav = 0.4 * np.sin(2 * np.pi * (150 + 37 * target) * t) + 0.01 * rng.standard_normal(len(t))
                write_wav(os.path.join(root, "audio", name), wav.astype(np.float32), sr)
                rows.append(f"{name},{fold},{target},{cat}")
    with open(os.path.join(root, "esc50.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_synthetic_audioset(root, train=AS_TRAIN, evals=AS_EVAL, labels=AS_LABELS, seconds=LOOP_SECONDS,
                             seed=0):
    """A seeded synthetic AudioSet in the layout the JAX package's tests
    fabricate (``tests/data_synth.py:make_synth_audioset``): an
    ``ontology.json`` of ``labels`` + 3 labels (those 3 absent from
    ``eval_segments.csv``, which names all the others), and the ``as_train`` /
    ``as_eval`` indexes of ``write_synthetic_va`` clips (10 s wav, a 256 x 256
    JPEG frame) with 1 to 3 labels each, drawn with a skew so that the
    weighted sampling has work to do."""
    import os

    rng = np.random.default_rng(seed)
    ids = [f"/m/vt{i:04d}" for i in range(labels + 3)]
    names = [" ".join(rng.choice(LA_WORDS, 2)) for _ in ids]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "ontology.json"), "w") as f:
        json.dump([{"id": i, "name": n} for i, n in zip(ids, names)], f)
    seg = ["# Segments csv", "# num_ytids=0", "# YTID, start_seconds, end_seconds, positive_labels"]
    for i in range(labels):
        seg.append(f'seg{i}, 0.000, 10.000, "{ids[i]},{ids[(i * 7 + 3) % labels]}"')
    with open(os.path.join(root, "eval_segments.csv"), "w") as f:
        f.write("\n".join(seg) + "\n")
    p = 1.0 / np.arange(1, labels + 1)  # a Zipf skew over the labels
    for name, n, s in (("as_train", train, seed), ("as_eval", evals, seed + 1)):
        records = write_synthetic_va(root, name, n, seconds=seconds, seed=s)
        for rec in records:
            k = int(rng.integers(1, 4))
            rec["labels"] = [ids[j] for j in rng.choice(labels, k, replace=False, p=p / p.sum())]
        with open(os.path.join(root, f"{name}.jsonl"), "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))


def _host_cpu():
    try:
        with open("/proc/cpuinfo") as f:
            return next(line.split(":", 1)[1].strip() for line in f if line.startswith("model name"))
    except (OSError, StopIteration):
        return "unknown CPU"


def _report_numbers(report):
    nums = [float(v) for v in re.findall(r"= (\S+)", report)]
    if not nums or not all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in nums):
        raise AssertionError(f"report numbers not finite or outside [0, 100]: {report}")
    return nums


def clf_phase(torch, results):
    """(a) the native host fbank; (b) ESC-50 zero-shot; (c) the ESC-50
    supervised x-fold; (d) AudioSet multi-label with the imagine branch;
    (e) the engine with ``worker=ESClassifier``. ``learn`` builds each
    fold's model afresh, so the steps timed in (c) before it leave no trace.
    The x-fold runs on the
    thread loader: its ten loaders (a training and an eval loader a fold) on
    spawned workers would spend 8-15 s each on a first batch (PERF.md §7).
    AudioSet trains on the process loader with 8 workers."""
    import collections
    import glob
    import os
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from vipant_tpu_torch import native
    from vipant_tpu_torch.data import transforms_audio
    from vipant_tpu_torch.data.esc50 import AudioLabelCollator
    from vipant_tpu_torch.ops.fbank_np import FbankParams, fbank as fbank_np
    from vipant_tpu_torch.serve import InferenceEngine
    from vipant_tpu_torch.train import ASTrainer, ESCTrainer, build_monitor, loss_and_grads

    smi = _smi()
    path_counts = collections.Counter()  # the launches of every run of the path, summed
    count_launches = _counting(torch, path_counts)

    root = tempfile.mkdtemp(prefix="vipant_clf_")
    workers = min(8, os.cpu_count() or 1)
    try:
        # (a) the native fbank, built from the checkout's source on the card's host into this
        # phase's directory; the library this process loads (and featurises with in (b) to (e))
        # must be that build
        default_root, native.BUILD_ROOT = native.BUILD_ROOT, Path(root) / "native"
        native._load.cache_clear()
        try:
            if not native.native_available():
                raise AssertionError("the native host fbank did not build or load")
            loaded = Path(native._load()._name)
        finally:
            native.BUILD_ROOT = default_root
        if Path(root) not in loaded.parents:
            raise AssertionError(f"the native fbank loaded {loaded}, not this phase's build")
        built = float((loaded.parent / "build_seconds").read_text())
        wav = _clip_batch(1, 10.05)[0]
        got, want = native.fbank_native(wav, FbankParams()), fbank_np(wav)
        err = float(np.abs(got - want).max())
        ms = {}
        for name, fn, reps in (("native", lambda: native.fbank_native(wav, FbankParams()), 20),
                               ("numpy", lambda: fbank_np(wav), 5)):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms[name] = (time.perf_counter() - t0) / reps * 1e3
        print(f"(a) native fbank built from {native.SOURCE.name} in {built:.2f} s ({loaded}); a 10.05 s clip "
              f"({got.shape[0]} frames): max |d| against fbank_np {err:.3e} (bound {NATIVE_TOL}); "
              f"ms per clip native {ms['native']:.3f}, NumPy {ms['numpy']:.3f} "
              f"({ms['numpy'] / ms['native']:.1f}x) on the host's {_host_cpu()} ({os.cpu_count()} cores), "
              f"beside {smi}")
        if got.shape != want.shape or not err <= NATIVE_TOL:
            raise AssertionError(f"the native fbank disagrees with fbank_np: {err}")

        # the full-width synthetic CLIP file and the ESC-50 tree
        t0 = time.perf_counter()
        clip_root = os.path.join(root, "clip")
        os.makedirs(clip_root)
        torch.save(synthetic_clip_state_dict(torch), os.path.join(clip_root, CLIP_NAME + ".pt"))
        with_clip = [f"running.clip_model_root={clip_root}", f"running.clip_model_name={CLIP_NAME}"]
        esc_root = os.path.join(root, "esc50")
        write_synthetic_esc50(esc_root)
        n_esc = len(ESC_CLASSES) * ESC_FOLDS
        print(f"a seeded CLIP ViT-B/32 file and a synthetic ESC-50 tree ({len(ESC_CLASSES)} classes, "
              f"{ESC_FOLDS} folds, {n_esc} clips of {ESC_SECONDS:.0f} s) written in "
              f"{time.perf_counter() - t0:.1f} s")
        esc = ESC_FULL + with_clip + [f"running.data_root={esc_root}", f"running.batch_size={ESC_B}",
                                      "loader_backend=thread", f"num_proc={workers}",
                                      f"alias_root={root}/run", f"model_root={root}/run"]

        # (b) ESC-50 zero-shot at full width, the host featurisation counted by route
        routes = collections.Counter()
        lock = threading.Lock()

        def counted(name, fn):
            def wrapped(*a, **k):
                with lock:
                    routes[name] += 1
                return fn(*a, **k)
            return wrapped

        zs = build_monitor(esc + ["running.zero_shot=True", "eval=True", "model_name=zs"])  # on the card
        if not isinstance(zs, ESCTrainer) or zs.output_dim != len(ESC_CLASSES):
            raise AssertionError("ESCMonitor did not build an ESCTrainer over the 50 classes")
        te = zs.encode_label_texts()
        batch = AudioLabelCollator()([zs.folds[0][1].dataset[i] for i in range(ESC_B)])
        audio = zs.make_batch(batch["audio"])[0]
        with torch.no_grad():
            ae = zs.model.encode_audio(audio).float().cpu().numpy()
        with plain_ops():
            tp = zs.encode_label_texts()
            with torch.no_grad():
                ap = zs.model.encode_audio(audio).float().cpu().numpy()
        cos = {"prompts": float(_row_cos(te, tp).min()), "audio": float(_row_cos(ae, ap).min())}
        with mock.patch.object(native, "fbank_native", counted("native", native.fbank_native)), \
                mock.patch.object(transforms_audio, "fbank_np", counted("numpy", transforms_audio.fbank_np)):
            t0 = time.perf_counter()
            p1 = count_launches(zs.learn)
            dt = time.perf_counter() - t0
        print(f"(b) ESC-50 zero-shot: {te.shape[0]} prompt embeddings and a B{ESC_B} batch of audio "
              f"embeddings against the plain ops, min row cosine {cos} (bound {COS_MIN}); pooled P@1 "
              f"{p1:.2f} over {n_esc} clips in {dt:.1f} s; host fbank calls by route {dict(routes)}")
        if (min(cos.values()) < COS_MIN or te.shape[0] != len(ESC_CLASSES) or not 0.0 <= p1 <= 100.0
                or routes["native"] < n_esc or routes["numpy"]):
            raise AssertionError(f"ESC-50 zero-shot failed: {cos}, P@1 {p1}, routes {dict(routes)}")
        del zs, audio
        torch.cuda.empty_cache()

        # (c) the supervised x-fold: a fresh model and optimizer a fold, 4 steps of B50 each
        xf = esc + ["running.zero_shot=False", "eval=False", "running.epochs=1", "running.peep_rate=1",
                    "metrics_jsonl=True", "model_name=xfold"]
        tr = build_monitor(xf)  # on the card
        items = [tr.folds[0][0].dataset[i] for i in range(ESC_B)]
        batch = AudioLabelCollator()(items)
        args = tr.make_batch(batch["audio"], batch["label"])
        k_run = loss_and_grads(tr.state, *args)
        with plain_ops():
            p_run = loss_and_grads(tr.state, *args)
            ref = build_monitor(xf + ["compute_dtype=float32", "model_name=xfold_f32"])
            f_run = loss_and_grads(ref.state, *args)
        del ref
        hold_grads_to_fp32(torch, f"(c) fold 1 B={ESC_B}", "ESC", k_run, p_run, f_run)
        del k_run, p_run, f_run
        step_ms = cuda_ms(torch, lambda: tr.train_step(*args), 5, 2)
        t0 = time.perf_counter()
        mean = count_launches(tr.learn)
        dt = time.perf_counter() - t0
        losses = _loop_losses(tr)
        print(f"(c) ESC-50 x-fold: {ESC_FOLDS} folds of {tr.steps_per_epoch} steps at B={ESC_B} in "
              f"{dt:.1f} s, losses {[round(v, 4) for v in losses]}; summary_report mean P@1 {mean:.2f}; "
              f"the step alone {step_ms:.2f} ms ({smi})")
        if (len(losses) != ESC_FOLDS * tr.steps_per_epoch or not np.isfinite(losses).all()
                or not 0.0 <= mean <= 100.0):
            raise AssertionError(f"the ESC-50 x-fold failed: {losses}, mean {mean}")
        del tr, args
        torch.cuda.empty_cache()

        # (d) AudioSet multi-label with the imagine branch, on the process loader
        as_root = os.path.join(root, "audioset")
        t0 = time.perf_counter()
        write_synthetic_audioset(as_root)
        print(f"synthetic AudioSet: {AS_LABELS} labels in the ontology and eval_segments.csv, "
              f"{AS_TRAIN} train and {AS_EVAL} eval clips of {LOOP_SECONDS:.0f} s with JPEG frames, "
              f"written in {time.perf_counter() - t0:.1f} s")
        mon = build_monitor(AS_FULL + with_clip + [
            f"running.data_root={as_root}", "running.data_name=as_train", "running.eval_name=as_eval",
            "running.test_name=", f"running.batch_size={AS_B}", "running.epochs=2", "running.peep_rate=1",
            "running.save_rate=1e9", "loader_backend=process", f"num_proc={workers}",
            f"alias_root={root}/run", f"model_root={root}/run", "model_name=as", "eval=False"])
        if not isinstance(mon, ASTrainer) or mon.output_dim != AS_LABELS or mon.loader.sample_weights is None:
            raise AssertionError("ASMonitor did not build an ASTrainer over the 527 labels, weighted")
        r = np.random.default_rng(3)
        as_args = mon.make_batch(r.standard_normal((AS_B, 3, 224, 224)).astype(np.float32),
                                 r.standard_normal((AS_B, 1, 1000, 128)).astype(np.float32),
                                 (r.random((AS_B, AS_LABELS)) < 0.01).astype(np.float32))
        as_ms = cuda_ms(torch, lambda: loss_and_grads(mon.state, *as_args), 5, 2)
        del as_args
        t0 = time.perf_counter()
        count_launches(mon.learn)
        dt = time.perf_counter() - t0
        with open(os.path.join(mon.out_dir, "train_0.out")) as f:
            parts = [tuple(float(v) for v in m.groups()) for m in
                     re.finditer(r"step \d+ loss (\S+) \(avg \S+\) bce (\S+) ce (\S+) ", f.read())]
        t0 = time.perf_counter()
        report = count_launches(lambda: mon.infer(mon.evalloader))
        zero = count_launches(lambda: mon.zero_shot(mon.evalloader))
        de = time.perf_counter() - t0
        print(f"(d) AudioSet: {mon.global_step} steps at B={AS_B} in {dt:.1f} s (the process loader's "
              f"first batches included), (loss, bce, ce) {parts}; fwd+bwd alone {as_ms:.2f} ms; "
              f"infer and zero-shot ({AS_LABELS} prompts) over {AS_EVAL} clips in {de:.1f} s: {report}; "
              f"{zero}")
        if len(parts) != 4 or not np.isfinite(parts).all():
            raise AssertionError(f"AudioSet losses or their parts are not finite: {parts}")
        _report_numbers(report)
        _report_numbers(zero)
        mon.close()
        del mon
        torch.cuda.empty_cache()

        # (e) the engine with worker=ESClassifier: zero-shot of 6 wav files against 5 labels
        files = sorted(glob.glob(os.path.join(esc_root, "audio", "*.wav")))[:SERVE_FILES]
        over = ["+running=esc50", *CLF_TOWERS, "+model/loss=ce", "worker=ESClassifier"] + with_clip
        classes = {c: [f"the sound of {c}"] for c in ENGINE_LABELS}
        eng = InferenceEngine(over, batch_size=BATCH)  # on the card
        fb = eng.fbank_files(files)
        zs_card = count_launches(lambda: eng.zero_shot(fb, classes))
        a, t = eng.embed_audio(fb), eng.embed_texts(list(ENGINE_LABELS), prompt="the sound of ")
        cpu = InferenceEngine(over + ["compute_dtype=float32"], batch_size=BATCH, device="cpu")
        ca, ct = cpu.embed_audio(fb), cpu.embed_texts(list(ENGINE_LABELS), prompt="the sound of ")
        zs_cpu = cpu.zero_shot(fb, classes)
        cos = {"audio": float(_row_cos(a, ca).min()), "text": float(_row_cos(t, ct).min())}
        dscore = float(np.abs(zs_card["scores"] - zs_cpu["scores"]).max())
        print(f"(e) ESClassifier engine: zero_shot of {len(files)} wav files against {len(classes)} labels, "
              f"{zs_card['prediction']} (the CPU engine: {zs_cpu['prediction']}); against the CPU engine "
              f"(plain ops, fp32) min row cosine {cos} (bound {COS_MIN}), scores max |d| {dscore:.4f} "
              f"(bound {SCORE_TOL})")
        if min(cos.values()) < COS_MIN or dscore > SCORE_TOL:
            raise AssertionError(f"the ESClassifier engine disagrees with the CPU engine: {cos}, {dscore}")
        del eng, cpu
        torch.cuda.empty_cache()

        counts = dict(path_counts)
        print(f"launches on the classification path: {json.dumps(counts, sort_keys=True)}")
        for name in ("fused_ln_attention_block", "fused_ln_mlp_block", "fused_ln_attention_block_bwd",
                     "fused_ln_mlp_block_bwd"):
            if not counts.get(name):
                raise AssertionError(f"{name} was not launched on the classification path")
        record_launches(results, "clf", counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 19: the packed shards (pak VA, AT and AudioSet) with the loader's one-gather batch path
PAK_LEN = 1030  # the pack's rows: longer than max_len, so the train crop has work to do
PAK_AT_SECONDS = 10.5  # phase 15's Clotho clips cut from 20 s: the packed rows hold 10 s


def _counting(torch, counts):
    """``fn()`` with the kernel launches it makes added to ``counts``."""
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches

    def run(fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts.update(LAUNCHES)
        return out
    return run


def _pack_cli(root, over, name, out, *extra):
    """``python -m vipant_tpu_torch.data.packed`` in a subprocess: (pack dir,
    seconds, bytes on disk)."""
    import os

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "vipant_tpu_torch.data.packed", *over,
                           f"running.data_root={root}", f"running.data_name={name}",
                           f"pack.out={out}", *extra], capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"the packing CLI failed: {proc.stderr[-2000:]}")
    d = proc.stdout.strip().splitlines()[-1]
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    return d, time.perf_counter() - t0, nbytes


def pak_phase(torch, results):
    """(a) pack phase 14's synthetic VA index through the CLI and hold the
    pack's eval batches bitwise to the npz dataset's ``ship_bf16`` batches;
    (b) ``VAMonitor`` at the VA step's full width on the pack (thread loader,
    a batch one gather): 2 epochs of 4 steps with a save and an eval at step
    6, a resume from it bitwise, the loop's steady window over the split
    read 3 times, and the host's ms to assemble a batch; (c) ``LAMonitor`` at
    ``CLAP_FULL`` on a packed synthetic Clotho; (d) ``ASMonitor`` on a packed
    synthetic AudioSet, weighted, then ``infer``."""
    import collections
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.config import compose
    from vipant_tpu_torch.data import build_audioset_label_map, build_image_audio_dataloader, packed
    from vipant_tpu_torch.data.image_audio import ImageAudioCollator, ImageAudioDatasetNpz
    from vipant_tpu_torch.train import ASTrainer, LATrainer, build_monitor

    smi = _smi()
    counts = collections.Counter()
    count = _counting(torch, counts)
    root = tempfile.mkdtemp(prefix="vipant_pak_")
    workers = min(8, os.cpu_count() or 1)
    ship = ["running.audio.ship_bf16=True", "running.image_uint8=True"]
    try:
        t0 = time.perf_counter()
        write_synthetic_va(root, "train", LOOP_TRAIN, npz_name="npz_train", seed=0)
        with open(os.path.join(root, "npz_train.jsonl")) as f, \
                open(os.path.join(root, "npz_train_long.jsonl"), "w") as g:
            g.writelines(f.readlines() * LOOP_NPZ_REPEAT)
        print(f"synthetic index: {LOOP_TRAIN} clips of {LOOP_SECONDS:.0f} s with {LOOP_FRAME}x{LOOP_FRAME} "
              f"JPEG frames and the npz twin (1000x128 fbanks), written in {time.perf_counter() - t0:.1f} s")

        # (a) the CLI packs the npz twin; its eval batches are the npz dataset's ship_bf16 batches
        over = FLAGSHIP + ship + [f"running.batch_size={LOOP_B}", f"num_proc={workers}"]
        pak, sec, nbytes = _pack_cli(root, over, "npz_train", "pak_train", f"pack.len={PAK_LEN}")
        _, sec_long, bytes_long = _pack_cli(root, over, "npz_train_long", "pak_long", f"pack.len={PAK_LEN}")
        cfg = compose(over + [f"running.data_root={root}", "loader_backend=thread"])
        got = list(build_image_audio_dataloader(cfg, "pak_train", False))
        want = list(build_image_audio_dataloader(cfg, "npz_train", False))
        same = [all(g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]) for k in ("audio", "image"))
                and g["name"] == w["name"] for g, w in zip(got, want)]
        print(f"(a) python -m vipant_tpu_torch.data.packed pack.len={PAK_LEN}: {LOOP_TRAIN} rows in "
              f"{sec:.2f} s, {nbytes / 2 ** 20:.1f} MiB ({os.path.basename(pak)}); the split read "
              f"{LOOP_NPZ_REPEAT} times: {sec_long:.2f} s, {bytes_long / 2 ** 20:.1f} MiB; eval batches "
              f"bitwise the npz dataset's ship_bf16 batches: {sum(same)} of {len(want)}")
        if len(got) != len(want) or not all(same) or got[0]["audio"].dtype != np.uint16:
            raise AssertionError("the pack's eval batches are not the npz dataset's ship_bf16 batches")
        del got, want

        # (b) VAMonitor on the pack: run A, 8 steps with a save and an eval at step 6
        run = os.path.join(root, "run")

        def va(*extra):
            torch.cuda.empty_cache()
            return build_monitor(over + [
                f"running.data_root={root}", "running.data_name=pak_train", "running.eval_name=pak_train",
                "running.eval_samples=64", "running.epochs=2", "loader_backend=thread",
                "running.peep_rate=1", "running.save_rate=6", "running.save_epoch=False",
                f"alias_root={run}", f"model_root={run}", "model_name=pak", "eval=False",
                "metrics_jsonl=True", *extra])

        a = va()
        if not isinstance(a.loader.dataset, packed.ImageAudioDatasetPak):
            raise AssertionError("VAMonitor did not read the pack")
        t0 = time.perf_counter()
        count(a.learn)
        want = _snapshot(a)
        losses = _loop_losses(a)
        print(f"(b) run A on the pack: {a.global_step} steps (2 epochs of {a.steps_per_epoch}), a save and an "
              f"eval at step 6, in {time.perf_counter() - t0:.1f} s; losses {[round(v, 5) for v in losses]}")
        if len(losses) != 8 or not np.isfinite(losses).all():
            raise AssertionError(f"the pak VA run's losses: {losses}")
        a.close()
        del a
        b = va("model_file=00000006", "running.eval_name=")
        count(b.learn)
        diff, what = _resume_diff(torch, b, want)
        print(f"(b) run B (resumed from step 6, the thread loader) against run A at step 8: {what}, "
              f"{len(diff)} not bitwise equal")
        if diff or b.global_step != 8:
            raise AssertionError(f"the pak resume is not bitwise: {sorted(diff.items())[:5]}")
        del b, want

        # (b) the loop's steady window on the split read 3 times, and one batch's host assembly
        tr = va("running.data_name=pak_long", "running.eval_name=", "running.save_rate=1000000000")
        tail = 2 * tr.loader.prefetch + 2
        ms, clips, share, steps, series = count(lambda: _timed_epoch(torch, tr, 0, tail))
        args = tr.device_put.wait(next(iter(tr.loader)))
        tr.close()
        alone = cuda_ms(torch, lambda: tr.train_step(*args), 5, 2)
        del tr, args
        ds = packed.ImageAudioDatasetPak(cfg.running, "pak_train", True)
        npz = ImageAudioDatasetNpz(compose(over + [f"running.data_root={root}"]).running, "npz_train", True)
        idxs = list(range(LOOP_B))
        host = {"get_batch": _timed_ms(torch, lambda: ds.get_batch(idxs, 1), 5),
                "npz items + collate": _timed_ms(
                    torch, lambda: ImageAudioCollator()([npz[i] for i in idxs]), 3)}
        npz_loop = results.get("_loop_windows", {}).get("npz")
        print(f"(b) pak source, each step's (wait for the batch, train_step call) ms: {series}")
        print(f"(b) pak source, a window of {steps} steps: {ms:.2f} ms per step of the loop, {clips:.1f} "
              f"clips/s, data-wait share {100 * share:.1f} %; the step alone on a loader batch {alone:.2f} ms; "
              f"phase 14's npz window "
              f"{'%.2f ms, %.1f clips/s, %.1f %%' % (npz_loop[0], npz_loop[1], 100 * npz_loop[2]) if npz_loop else 'not run'}; "
              f"one batch of {LOOP_B} on the host: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in host.items()) + f"; {smi}")
        results["_pak_window"] = (ms, clips, share)

        # (c) LAMonitor at CLAP_FULL on a packed synthetic Clotho
        t0 = time.perf_counter()
        write_synthetic_clotho(root, "clotho_train", LA_TRAIN, seconds=PAK_AT_SECONDS)
        write_synthetic_clotho(root, "clotho_val", LA_EVAL, seconds=PAK_AT_SECONDS, seed=1)
        la_over = LA_FULL + ship + [f"running.batch_size={LA_B}", f"running.data_root={root}"]
        la_cfg = compose(la_over)
        for name in ("clotho_train", "clotho_val"):
            packed.pack_audio_text(la_cfg.running, la_cfg.model, name)
        print(f"(c) synthetic Clotho ({LA_TRAIN} + {LA_EVAL} clips of {PAK_AT_SECONDS:.1f} s) written and "
              f"packed in {time.perf_counter() - t0:.1f} s")
        la = _la_monitor(torch, *ship, f"running.data_root={root}", "running.data_name=pak_clotho_train",
                         "running.eval_name=pak_clotho_val", "running.test_name=", "running.epochs=1",
                         "running.peep_rate=1", "running.save_rate=1000000000", "running.save_epoch=True",
                         "running.eval_loss_bound=inf", "loader_backend=thread", f"num_proc={workers}",
                         f"alias_root={run}", f"model_root={run}", "model_name=pak_la", "eval=False")
        if not isinstance(la, LATrainer) or not isinstance(la.loader.dataset, packed.AudioTextDatasetPak):
            raise AssertionError("LAMonitor did not read the AT pack")
        t0 = time.perf_counter()
        count(la.learn)
        reports = _logged_reports(la.out_dir)
        print(f"(c) LAMonitor on the pack: {la.global_step} steps at B={LA_B} and an eval in "
              f"{time.perf_counter() - t0:.1f} s; {reports[-1][1] if reports else 'no report'}")
        if la.global_step != 4 or len(reports) != 1:
            raise AssertionError(f"the AT pak run: {la.global_step} steps, reports {reports}")
        _report_finite(reports[-1][1])
        la.close()
        del la

        # (d) ASMonitor on a packed synthetic AudioSet: weighted sampling, no mixup, then infer
        as_root = os.path.join(root, "audioset")
        t0 = time.perf_counter()
        write_synthetic_audioset(as_root)
        as_over = AS_FULL + ship + [f"running.data_root={as_root}", "running.mixup_rate=0.0"]
        as_cfg = compose(as_over)
        label_map = build_audioset_label_map(as_cfg.running)
        for name in ("as_train", "as_eval"):
            packed.pack_audioset(as_cfg.running, name, label_map)
        print(f"(d) synthetic AudioSet ({AS_TRAIN} + {AS_EVAL} clips, {AS_LABELS} labels) written and "
              f"packed in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        mon = build_monitor(as_over + [
            "running.data_name=pak_as_train", "running.eval_name=pak_as_eval", "running.test_name=",
            f"running.batch_size={AS_B}", "running.epochs=2", "running.peep_rate=1",
            "running.save_rate=1e9", "running.save_epoch=False", "loader_backend=thread",
            f"num_proc={workers}", f"alias_root={run}", f"model_root={run}", "model_name=pak_as",
            "eval=False"])
        if (not isinstance(mon, ASTrainer) or mon.loader.sample_weights is None
                or not isinstance(mon.loader.dataset, packed.AudiosetDatasetPak)):
            raise AssertionError("ASMonitor did not read the AudioSet pack, weighted")
        t0 = time.perf_counter()
        count(mon.learn)
        report = count(lambda: mon.infer(mon.evalloader))
        print(f"(d) ASMonitor on the pack: {mon.global_step} steps at B={AS_B} in "
              f"{time.perf_counter() - t0:.1f} s with infer: {report}")
        if mon.global_step != 4:
            raise AssertionError(f"the AudioSet pak run took {mon.global_step} steps")
        _report_numbers(report)
        mon.close()
        del mon
        torch.cuda.empty_cache()

        counts = dict(counts)
        print(f"launches on the pak path: {json.dumps(counts, sort_keys=True)}")
        for name in ("fused_ln_attention_block", "fused_ln_mlp_block", "fused_ln_attention_block_bwd",
                     "fused_ln_mlp_block_bwd"):
            if not counts.get(name):
                raise AssertionError(f"{name} was not launched on the pak path")
        record_launches(results, "pak", counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 20: the trimodal (CVALP, with and without siamese ties), siamese (CVASP) and Barlow paths
VAL_FULL = [  # the trimodal step: CLAP_FULL's towers and the ViT-B/32 image tower, running/trimodal.yaml
    "+running=trimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=transformer_val",
    "+model/loss=ce_val", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=1000", "model.loss.lv=True",
    "worker=CVALP", "monitor=VALMonitor", "model_file=",
]
VAL_TIED = VAL_FULL + ["running.siamese.alive=True", "running.siamese.amodules=[encoder,misc]"]
VAS_FULL = [  # running/siamese.yaml with the five views' loss
    "+running=siamese", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce_va", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=1000", "running.multi_view=True",
    "model.loss.aa=True", "worker=CVASP", "monitor=VASMonitor", "model_file=",
]
BARLOW_FULL = [o for o in FLAGSHIP if o != "+model/loss=ce"] + ["+model/loss=barlow_ce"]
VAS_TRAIN, BARLOW_TRAIN = 256, 192  # 4 steps, 3 steps at B = 64


def trimodal_phase(torch, results):
    """(a) ``VALMonitor`` / ``CVALP`` at full width on a synthetic AudioSet
    (label texts as captions), the image and text towers frozen, the audio
    tower trained, ``ce_val`` with ``va``, ``al`` and ``lv``: 4 steps,
    ``infer``, ``zero_shot``; then again with the audio tower's encoder and
    positional embedding tied to the image tower's, whose tied stages then
    train. (b) ``VASMonitor`` / ``CVASP`` on phase 14's index with the four
    views: 4 steps and ``infer``, and a resume from step 2 on 8 process
    workers bitwise. (c) ``VAMonitor`` with ``barlow_ce``: 3 steps, the
    BatchNorm statistics moved, an eval call that reads them unchanged, and a
    resume bitwise, statistics included."""
    import collections
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.config import compose
    from vipant_tpu_torch.data import build_image_audio_dataloader
    from vipant_tpu_torch.train import VALTrainer, VASTrainer, build_monitor

    smi = _smi()
    root = tempfile.mkdtemp(prefix="vipant_val_")
    workers = min(8, os.cpu_count() or 1)
    run = os.path.join(root, "run")
    try:
        t0 = time.perf_counter()
        as_root = os.path.join(root, "audioset")
        write_synthetic_audioset(as_root)
        write_synthetic_va(root, "train", VAS_TRAIN, npz_name="npz_train", seed=0)
        print(f"synthetic AudioSet ({AS_TRAIN} + {AS_EVAL} clips) and VA index ({VAS_TRAIN} clips with "
              f"the npz twin) written in {time.perf_counter() - t0:.1f} s")

        # (a) VALMonitor, untied then tied
        val_counts = collections.Counter()
        count = _counting(torch, val_counts)
        for i, (label, over) in enumerate((("untied", VAL_FULL), ("tied encoder+misc", VAL_TIED))):
            torch.cuda.empty_cache()
            mon = build_monitor(over + [
                f"running.data_root={as_root}", "running.data_name=as_train", "running.eval_name=as_eval",
                "running.test_name=", f"running.batch_size={AS_B}", "running.epochs=2", "running.peep_rate=1",
                "running.save_rate=1e9", "running.save_epoch=False", "running.zero_shot=True",
                "loader_backend=thread",
                f"num_proc={workers}", f"alias_root={run}", f"model_root={run}", f"model_name=val{i}",
                "eval=False"])
            if not isinstance(mon, VALTrainer):
                raise AssertionError("VALMonitor did not build a VALTrainer")
            image = dict(mon.model.image.named_parameters())
            before = {k: p.detach().clone() for k, p in image.items()}
            t0 = time.perf_counter()
            count(mon.learn)
            dt = time.perf_counter() - t0
            with open(os.path.join(mon.out_dir, "train_0.out")) as f:
                parts = [tuple(float(v) for v in m.groups()) for m in re.finditer(
                    r"step \d+ loss (\S+) \(avg \S+\) al (\S+) lv (\S+) va (\S+) ", f.read())]
            t0 = time.perf_counter()
            report = count(lambda: mon.infer(mon.evalloader))
            de = time.perf_counter() - t0
            moved = {k for k, p in image.items() if not torch.equal(p.detach(), before[k])}
            tied = [(d, s) for d, s in mon.ties]
            shared = all(p is q for d, s in tied for p, q in zip(
                mon.model.get_submodule(d.replace("/", ".")).parameters(),
                mon.model.get_submodule(s.replace("/", ".")).parameters()))
            print(f"(a) VALMonitor {label}: ties {tied}; {mon.global_step} steps at B={AS_B} in {dt:.1f} s, "
                  f"(loss, al, lv, va) {parts}; {len(moved)} of {len(image)} image-tower params moved; "
                  f"{sum(p.numel() for p in mon.trainable.values()):,} trainable params; infer with "
                  f"zero-shot ({AS_LABELS} prompts) over {AS_EVAL} clips in {de:.1f} s: {report}")
            if len(parts) != 4 or not np.isfinite(parts).all():
                raise AssertionError(f"the VAL losses or their parts are not finite: {parts}")
            nums = [float(t1 or p1) for t1, p1 in re.findall(r"t1 (\S+)|p1 = (\S+)", report)]
            if len(nums) != 5 or not all(0.0 <= v <= 100.0 for v in nums):
                raise AssertionError(f"the VAL report: {report}")
            if tied:
                stages = {k.split(".")[0] for k in moved}
                if not shared or "encoder" not in stages or not stages <= {"encoder", "misc"}:
                    raise AssertionError(f"the tied run: one storage {shared}, moved stages {stages}")
            elif moved:
                raise AssertionError(f"the frozen image tower moved in the untied run: {sorted(moved)[:3]}")
            mon.close()
            del mon, image, before
        record_launches(results, "val", dict(val_counts))

        # (b) VASMonitor on the four views, resumed from step 2 on 8 process workers
        vas_counts = collections.Counter()
        count = _counting(torch, vas_counts)

        def vas(*extra):
            torch.cuda.empty_cache()
            return build_monitor(VAS_FULL + [
                f"running.data_root={root}", "running.data_name=train", "running.eval_name=train",
                "running.eval_samples=64", f"running.batch_size={LOOP_B}", "running.epochs=1",
                "running.peep_rate=1", "running.save_rate=2", "running.save_epoch=False",
                "loader_backend=process", f"num_proc={workers}", f"alias_root={run}", f"model_root={run}",
                "model_name=vas", "eval=False", *extra])

        a = vas("running.eval_name=")
        if not isinstance(a, VASTrainer):
            raise AssertionError("VASMonitor did not build a VASTrainer")
        t0 = time.perf_counter()
        count(a.learn)
        want = _snapshot(a)
        with open(os.path.join(a.out_dir, "train_0.out")) as f:
            parts = [tuple(float(v) for v in m.groups()) for m in re.finditer(
                r"step \d+ loss (\S+) \(avg \S+\) aa (\S+) va (\S+) vp (\S+) vv (\S+) ", f.read())]
        print(f"(b) VASMonitor: {a.global_step} steps at B={LOOP_B} on {workers} process workers in "
              f"{time.perf_counter() - t0:.1f} s, (loss, aa, va, vp, vv) {parts}")
        if len(parts) != 4 or not np.isfinite(parts).all():
            raise AssertionError(f"the VAS losses or their parts are not finite: {parts}")
        a.close()
        del a
        b = vas("model_file=00000002", "running.eval_name=")
        count(b.learn)
        diff, what = _resume_diff(torch, b, want)
        evalloader = build_image_audio_dataloader(compose(VAS_FULL + [
            f"running.data_root={root}", "running.eval_samples=64", f"running.batch_size={LOOP_B}",
            "loader_backend=thread", f"num_proc={workers}"]), "train", False)
        report = count(lambda: b.infer(evalloader))
        print(f"(b) resumed from step 2 on {workers} process workers against the uninterrupted run at step "
              f"4: {what}, {len(diff)} not bitwise equal; infer: {report}")
        if diff or b.global_step != 4:
            raise AssertionError(f"the siamese resume is not bitwise: {sorted(diff.items())[:5]}")
        if not re.fullmatch(r"I->A: t1 = \S+ A->I: t1 = \S+ @ \d+", report):
            raise AssertionError(f"the VAS report: {report}")
        b.close()
        del b, want
        record_launches(results, "vas", dict(vas_counts))

        # (c) VAMonitor with barlow_ce: its BatchNorm statistics
        barlow_counts = collections.Counter()
        count = _counting(torch, barlow_counts)

        def barlow(*extra):
            torch.cuda.empty_cache()
            return build_monitor(BARLOW_FULL + [
                f"running.data_root={root}", "running.data_name=npz_barlow", "running.eval_name=",
                f"running.batch_size={LOOP_B}", "running.epochs=1", "running.audio.transform_fbank=False",
                "running.peep_rate=1", "running.save_rate=2", "running.save_epoch=False",
                "loader_backend=thread", f"num_proc={workers}", f"alias_root={run}", f"model_root={run}",
                "model_name=barlow", "eval=False", *extra])

        with open(os.path.join(root, "npz_train.jsonl")) as f, \
                open(os.path.join(root, "npz_barlow.jsonl"), "w") as g:
            g.writelines(f.readlines()[:BARLOW_TRAIN])
        a = barlow()
        init = {k: v.clone() for k, v in a.state.buffers.items()}
        count(a.learn)
        stats = {k: v.clone() for k, v in a.state.buffers.items()}
        moved = [k for k, v in stats.items() if not torch.equal(v, init[k])]
        x = torch.nn.functional.normalize(torch.randn(LOOP_B, int(a.cfg.model.image.embed_dim), device=a.device), dim=-1)
        with torch.no_grad():
            out = count(lambda: a.model.loss(x, x.roll(1, 0), train=False))
        unchanged = all(torch.equal(v, stats[k]) for k, v in a.state.buffers.items())
        want = _snapshot(a)
        a.close()
        del a
        b = barlow("model_file=00000002")
        count(b.learn)
        diff, what = _resume_diff(torch, b, want)
        diff.update({k: float((v - stats[k]).abs().max()) for k, v in b.state.buffers.items()
                     if not torch.equal(v, stats[k])})
        print(f"(c) barlow_ce: 3 steps at B={LOOP_B}; {len(moved)} of {len(stats)} running statistics "
              f"moved; an eval call of the head {float(out):.4f} left them unchanged: {unchanged}; resumed "
              f"from step 2: {what} and {len(stats)} statistics, {len(diff)} not bitwise equal")
        if len(moved) != len(stats) or not stats or not unchanged or not np.isfinite(float(out)) or diff:
            raise AssertionError(f"Barlow's statistics: moved {moved}, unchanged {unchanged}, resume {diff}")
        b.close()
        del b, want
        record_launches(results, "barlow", dict(barlow_counts))

        for path, counts in (("val", val_counts), ("vas", vas_counts), ("barlow", barlow_counts)):
            print(f"launches on the {path} path: {json.dumps(dict(counts), sort_keys=True)}")
            for name in ("fused_ln_attention_block", "fused_ln_mlp_block", "fused_ln_attention_block_bwd",
                         "fused_ln_mlp_block_bwd"):
                if not counts.get(name):
                    raise AssertionError(f"{name} was not launched on the {path} path")
        print(f"  ({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# (name, title, function) of every phase, in the order a whole run takes them
DEIT_FULL = [  # the DeiT VA step: both towers DeiT-B/16 distilled, meme-seeded
    "+running=bimodal", "+model/image=deit", "+model/audio=deit", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default", "running.audio.max_len=1000",
    "worker=CVAP", "model_file=",
]
RN50_FULL = [  # the RN50 VA step: CLIP's ModifiedResNet-50 image tower frozen, the audio tower from it
    "+running=bimodal", "+model/image=rn50_val", "+model/audio=rn50_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default", "running.audio.max_len=1000",
    "worker=CVAP", "model_file=",
]
PATCHOUT_FULL = FLAGSHIP + ["model.audio.patchout=0.25"]
RN50_NAME = "synthetic-RN50"  # not a zoo name: loaded by the {root}/{name}.pt convention
# the DeiT grad check, phase 6 (i)'s batch: the plain fp32 attention keeps 1.1 GB of scores a layer. The last
# layers' bias grads sum the cls and dist rows only (2 B of them), so at B = 8 the gate reads the bf16 forward's
# rounding on 16 rows, on the plain ops as on the kernels (vipant_tpu_torch/experiments/deit_grad_gap.py)
DEIT_GRAD_B = 16
ASYNC_TRAIN, ASYNC_EVAL = 128, 16  # (d)'s index: two steps an epoch at B = 64


def synthetic_deit_state_dict(torch, seed=0, width=768, layers=12, grid=196, classes=1000):
    """A timm ``deit_base_distilled_patch16_224`` state dict drawn from
    ``seed`` at full width by default (768, 12 layers, 14 x 14 patches of
    16, 1000 classes): ViT-style scales, LayerNorm gains near 1. fp32,
    about 350 MB."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(name, shape, std, mean=0.0):
        sd[name] = torch.randn(shape, generator=g) * std + mean

    normal("pos_embed", (1, grid + 2, width), 0.02)
    normal("cls_token", (1, 1, width), 0.02)
    normal("dist_token", (1, 1, width), 0.02)
    normal("patch_embed.proj.weight", (width, 3, 16, 16), (3 * 16 * 16) ** -0.5)
    normal("patch_embed.proj.bias", (width,), 0.02)
    for i in range(layers):
        b = f"blocks.{i}."
        for name, shape, std in (("attn.qkv", (3 * width, width), width ** -0.5),
                                 ("attn.proj", (width, width), (2 * width * layers) ** -0.5),
                                 ("mlp.fc1", (4 * width, width), width ** -0.5),
                                 ("mlp.fc2", (width, 4 * width), (8 * width * layers) ** -0.5)):
            normal(b + name + ".weight", shape, std)
            normal(b + name + ".bias", shape[:1], 0.02)
        for ln in ("norm1", "norm2"):
            normal(b + ln + ".weight", (width,), 0.02, 1.0)
            normal(b + ln + ".bias", (width,), 0.02)
    normal("norm.weight", (width,), 0.02, 1.0)
    normal("norm.bias", (width,), 0.02)
    for head in ("head", "head_dist"):
        normal(head + ".weight", (classes, width), width ** -0.5)
        normal(head + ".bias", (classes,), 0.02)
    return sd


def synthetic_clip_rn50_state_dict(torch, seed=0, layers=(3, 4, 6, 3), width=64, emb=1024, grid=7):
    """The visual half of a CLIP RN50 state dict (ModifiedResNet-50: stem
    width 64, stages (3, 4, 6, 3), attention pool over a 7 x 7 grid at
    width 2048, 32 heads, embedding 1024) plus ``logit_scale``, drawn from
    ``seed``; BatchNorm statistics away from (0, 1). fp32, about 150 MB."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"visual.{name}.weight"] = torch.randn(cout, cin, k, k, generator=g) * (cin * k * k) ** -0.5

    def bn(name, c):
        sd[f"visual.{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=g)
        sd[f"visual.{name}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"visual.{name}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"visual.{name}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"visual.{name}.num_batches_tracked"] = torch.tensor(0)

    for i, (cout, cin) in enumerate(((width // 2, 3), (width // 2, width // 2), (width, width // 2)), 1):
        conv(f"conv{i}", cout, cin, 3)
        bn(f"bn{i}", cout)
    inplanes = width
    for s, blocks in enumerate(layers):
        planes = width * 2 ** s
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            conv(f"{p}.conv1", planes, inplanes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    C = width * 32
    sd["visual.attnpool.positional_embedding"] = torch.randn(grid * grid + 1, C, generator=g) * C ** -0.5
    for name, out in (("q_proj", C), ("k_proj", C), ("v_proj", C), ("c_proj", emb)):
        sd[f"visual.attnpool.{name}.weight"] = torch.randn(out, C, generator=g) * C ** -0.5
        sd[f"visual.attnpool.{name}.bias"] = 0.02 * torch.randn(out, generator=g)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return sd


def _ported_vs_tower(torch, tower, ported, own_names):
    """``(names not bitwise the CPU porter's tensor, names whose tensor is
    not the file's)``: ``ported`` the porter's CPU state dict, ``own_names``
    tower name -> the file's tensor for the tensors that are the file's
    unchanged."""
    sd = {**dict(tower.named_parameters()), **dict(tower.named_buffers())}
    off_port = [k for k, t in sd.items() if not torch.equal(t.detach().cpu(), ported[k])]
    off_file = [k for k, v in own_names.items() if not torch.equal(sd[k].detach().cpu(), v)]
    return off_port, off_file


def _step_launches(fwd_blocks, bwd_blocks, patches=2):
    """The launches of one training step whose towers run ``fwd_blocks``
    sub-block pairs forward and ``bwd_blocks`` backward, and ``patches``
    forwards of a tower with a patch embedding (train_phase's count)."""
    return {
        "fused_ln_attention_block": fwd_blocks, "fused_ln_mlp_block": fwd_blocks,
        "fused_ln_attention_block_bwd": bwd_blocks, "fused_ln_mlp_block_bwd": bwd_blocks,
        "layernorm_fwd": 2 * fwd_blocks + 2 * bwd_blocks, "gemm_bias_act": 4 * fwd_blocks + bwd_blocks,
        "attention_fwd": fwd_blocks, "attention_bwd": bwd_blocks, "layernorm_bwd": 2 * bwd_blocks,
        "colsum": 4 * bwd_blocks, "gemm_dgrad": 4 * bwd_blocks, "gemm_wgrad": 4 * bwd_blocks,
        "patch_gather": patches,
    }


def _count_step(torch, tr, batch, want, path, results):
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches

    reset_launches()
    m = tr.train_step(*batch)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    if counts != want:
        raise AssertionError(f"{path}: launch counts {counts} != expected {want}")
    record_launches(results, path, counts)
    return float(m["loss"])


def _step_ms(torch, tr, batch, reps=3):
    return cuda_ms(torch, lambda: tr.train_step(*batch), reps, 1)


def backbone_phase(torch, results):
    """(a) DeiT, (b) RN50, (c) patchout, (d) asynchronous checkpoints; see
    the module docstring."""
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.ckpt.clip_port import port_clip_resnet, split_clip_state_dict
    from vipant_tpu_torch.ckpt.deit_port import _BLOCK, port_deit
    from vipant_tpu_torch.ops import LAUNCHES, kernels, reset_launches
    from vipant_tpu_torch.serve import InferenceEngine
    from vipant_tpu_torch.train import Trainer, loss_and_grads

    smi = _smi()
    root = tempfile.mkdtemp(prefix="vipant_backbones_")
    try:
        # (a) DeiT: the streaming attention and the GELU epilogues at the step's shapes
        rn = _seeded(torch)
        T, C, H = DEIT_T, 768, 12
        for B in (DEIT_B, 16):  # the step's batch, and the grad check's
            qkv, do = rn(B, T, 3 * C), rn(B, T, C)
            o, stats = kernels.attention_fwd(qkv, None, H, 0.125, stats=True)
            compare(torch, results, "attention_fwd", f"DeiT audio B{B} T{T} C{C} H{H}, streaming",
                    lambda: kernels.attention_fwd(qkv, None, H, 0.125),
                    lambda: kernels.attention_plain(qkv, None, H, 0.125), reads=(qkv,),
                    ops=attn_ops(B, T, H), library=_sdpa(torch, qkv, None, H, 0.125), iters=3)
            compare(torch, results, "attention_bwd", f"DeiT audio B{B} T{T} C{C} H{H}, streaming",
                    lambda: kernels.attention_bwd(qkv, do, None, H, 0.125, stats),
                    lambda: kernels.attention_bwd_plain(qkv, do, None, H, 0.125), reads=(qkv, do, stats),
                    ops=attn_ops(B, T, H, products=5), library=_sdpa_bwd(torch, qkv, None, H, 0.125, do),
                    iters=3)
            if not torch.equal(kernels.attention_bwd(qkv, do, None, H, 0.125, stats)[0],
                               kernels.attention_bwd(qkv, do, None, H, 0.125, stats)[0]):
                raise AssertionError(f"attention_bwd at B{B} T{T}: two runs differ")
            del qkv, do, o, stats
            torch.cuda.empty_cache()
        M = DEIT_B * DEIT_T
        x, w, b = rn(M, C), rn(4 * C, C, std=C ** -0.5), rn(4 * C, std=0.02, dtype=torch.float32)
        compare(torch, results, "gemm_bias_act", f"DeiT audio B64 T{T} fc+gelu [M={M}]",
                lambda: kernels.gemm_bias_act(x, w, b, act="gelu"),
                lambda: kernels.gemm_bias_act_plain(x, w, b, act="gelu"), reads=(x, w, b),
                ops=gemm_ops(M, 4 * C, C), library=lambda: torch.nn.functional.gelu(
                    torch.nn.functional.linear(x, w, b.to(x.dtype))), iters=5)
        # the MLP backward's da = (gy . Wproj) * gelu'(a): gy [M, C], Wproj [C, 4C] as stored, a fp32
        gy, wp, a = rn(M, C), rn(C, 4 * C, std=(4 * C) ** -0.5), rn(M, 4 * C, dtype=torch.float32)
        compare(torch, results, "gemm_dgrad", f"DeiT audio B64 T{T} da=(gy.Wproj)*gelu'(a) [M={M}]",
                lambda: kernels.gemm_dgrad(gy, wp, True, "gelu", a),
                lambda: kernels.gemm_dgrad_plain(gy, wp, True, "gelu", a), reads=(gy, wp, a),
                ops=gemm_ops(M, 4 * C, C), library=lambda: torch.matmul(gy, wp), iters=5)
        del x, w, b, gy, wp, a
        torch.cuda.empty_cache()

        # the meme file, the trainer seeded from it, the step's towers against the porter
        t0 = time.perf_counter()
        meme = synthetic_deit_state_dict(torch)
        meme_path = os.path.join(root, "deit_base_distilled_patch16_224.pth")
        torch.save(meme, meme_path)
        deit = DEIT_FULL + [f"model.image.meme_path={meme_path}", f"model.audio.meme_path={meme_path}",
                            f"alias_root={root}", f"model_root={root}"]
        print(f"(a) synthetic timm DeiT-B/16 distilled file: "
              f"{os.path.getsize(meme_path) / 2 ** 20:.0f} MiB, written in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        tr = Trainer(deit + [f"running.batch_size={DEIT_GRAD_B}"], steps_per_epoch=STEPS_PER_EPOCH)
        kept = {"cls_token": "cls_token", "dist_token": "dist_token", "norm.weight": "norm.weight",
                "norm.bias": "norm.bias", "patch_embed.bias": "patch_embed.proj.bias",
                **{f"blocks.resblocks.{i}.{port}": f"blocks.{i}.{timm}"
                   for i in range(len(tr.model.audio.blocks.resblocks)) for timm, port in _BLOCK.items()}}
        for name in ("image", "audio"):
            tower = getattr(tr.model, name)
            own = {k: meme[v].reshape(-1) if v.endswith("_token") else meme[v] for k, v in kept.items()}
            if name == "image":
                own["patch_embed.weight"] = meme["patch_embed.proj.weight"]
            off_port, off_file = _ported_vs_tower(torch, tower, port_deit(meme, tower), own)
            if off_port or off_file:
                raise AssertionError(f"the meme-seeded {name} tower: not the porter's {off_port[:5]}, "
                                     f"not the file's {off_file[:5]}")
            print(f"(a) meme -> {name} tower (grid {tower.grid}, T = {tower.grid[0] * tower.grid[1] + 2}): "
                  f"every tensor bitwise the CPU porter's; {len(own)} of "
                  f"{len(list(tower.parameters()))} bitwise the file's (the rest: the re-gridded "
                  f"positions, the heads' seeded init{', the channel mean of the kernel' if name == 'audio' else ''})")
        g = torch.Generator().manual_seed(3)
        batch = tr.make_batch(torch.randn(DEIT_GRAD_B, 3, 224, 224, generator=g).numpy(),
                              torch.randn(DEIT_GRAD_B, 1, 1000, 128, generator=g).numpy())
        loss_k, g_k = loss_and_grads(tr.state, *batch)
        with torch.no_grad():
            emb_k = tr.model.encode_audio(batch[1])
            with plain_ops():
                emb_p = tr.model.encode_audio(batch[1])
        with plain_ops():
            loss_p, g_p = loss_and_grads(tr.state, *batch)
            ref = Trainer(deit + [f"running.batch_size={DEIT_GRAD_B}", "compute_dtype=float32"],
                          steps_per_epoch=STEPS_PER_EPOCH)
            loss_f, g_f = loss_and_grads(ref.state, *batch)
            with torch.no_grad():
                emb_f = ref.model.encode_audio(batch[1]).float()
        del ref
        err = {n: ((e.float() - emb_f).norm(dim=-1) / emb_f.norm(dim=-1)).max().item()
               for n, e in (("kernels", emb_k), ("plain", emb_p))}
        print(f"(a) DeiT audio embeddings at B={DEIT_GRAD_B}, eval: max relative distance to fp32 "
              f"kernels {err['kernels']:.6f}, plain {err['plain']:.6f}")
        hold_grads_to_fp32(torch, f"(a) DeiT B={DEIT_GRAD_B} T={DEIT_T}", "DeiT VA",
                           (loss_k, g_k), (loss_p, g_p), (loss_f, g_f))
        del g_k, g_p, g_f, tr, batch
        torch.cuda.empty_cache()

        tr = Trainer(deit + [f"running.batch_size={DEIT_B}", "optimizer.use_lars=False",
                             "optimizer.warmup=False", "optimizer.lr=1.0e-4"], steps_per_epoch=STEPS_PER_EPOCH)
        g = torch.Generator().manual_seed(4)
        images = torch.randn(DEIT_B, 3, 224, 224, generator=g).numpy()
        audios = torch.randn(DEIT_B, 1, 1000, 128, generator=g).numpy()
        batch = tr.make_batch(images, audios)
        losses = [_count_step(torch, tr, batch, _step_launches(24, 12), "deit", results)]
        losses += [float(tr.train_step(*batch)["loss"]) for _ in range(3)]
        ms = _step_ms(torch, tr, batch)
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(*batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"(a) DeiT VA step B={DEIT_B} (audio T={DEIT_T} trained, image T={DEIT_IMAGE_T} frozen), "
              f"Adam lr 1e-4 on one batch: losses {[round(v, 5) for v in losses]}; {ms:.2f} ms/step "
              f"({DEIT_B / ms * 1e3:.1f} clips/s), peak {peak:.2f} GiB ({smi}); the plain ops are not "
              f"timed at B={DEIT_B}: their fp32 scores take 4.35 GB a layer")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"DeiT step: the loss is not finite and falling: {losses}")
        results["_deit_step_ms"] = ms
        del tr, batch
        torch.cuda.empty_cache()
        eng = InferenceEngine(deit, batch_size=DEIT_B, seed=0)
        fb = audios[:, 0]
        reset_launches()
        got = eng.embed_audio(fb)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        with plain_ops():
            want = eng.embed_audio(fb)
        cos = _row_cos(got, want).min()
        t_k = _timed_ms(torch, lambda: eng.embed_audio(fb), 3)
        with plain_ops():
            t_p = _timed_ms(torch, lambda: eng.embed_audio(fb), 3)
        print(f"(a) DeiT engine embed_audio at batch {DEIT_B}: min cosine to the plain ops {cos:.6f}; "
              f"{t_k:.2f} ms a batch, plain {t_p:.2f} ms ({smi}); launches {json.dumps(counts, sort_keys=True)}")
        if not (np.isfinite(got).all() and cos >= COS_MIN):
            raise AssertionError(f"DeiT engine: cosine {cos} to the plain ops")
        for k, n in counts.items():
            results.setdefault(k, {"max_abs_err": 0.0, "cases": [], "launches": {}})
            results[k]["launches"]["deit"] = results[k]["launches"].get("deit", 0) + n
        del eng
        torch.cuda.empty_cache()

        # (b) RN50: CLIP-seeded towers, a step with the statistics moving, an engine
        clip = synthetic_clip_rn50_state_dict(torch)
        torch.save(clip, os.path.join(root, RN50_NAME + ".pt"))
        rn50 = RN50_FULL + [f"running.clip_model_root={root}", f"running.clip_model_name={RN50_NAME}",
                            f"alias_root={root}", f"model_root={root}", f"running.batch_size=64"]
        visual = split_clip_state_dict(clip)[0]
        trs = {}
        for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_ops)):
            torch.cuda.empty_cache()
            tr = Trainer(rn50, steps_per_epoch=STEPS_PER_EPOCH)
            if label == "kernels":
                for name in ("image", "audio"):
                    tower = getattr(tr.model, name)
                    ported = port_clip_resnet(visual, tower)
                    from_file = {k: v for k, v in ported.items() if k != "post_encoder.positional_embedding"}
                    off_port, off_file = _ported_vs_tower(torch, tower, ported, from_file)
                    if off_port or off_file:
                        raise AssertionError(f"CLIP RN50 -> {name}: not the porter's {off_port[:5]}, "
                                             f"not the file's {off_file[:5]}")
                    print(f"(b) CLIP RN50 -> {name} tower (grid {tower.grid}): every tensor and BatchNorm "
                          f"statistic bitwise the file's but the pool's positional grid "
                          f"({'7 x 7, kept' if tower.grid == (7, 7) else 're-gridded from 7 x 7'})")
                g = torch.Generator().manual_seed(5)
                batch = tr.make_batch(torch.randn(64, 3, 224, 224, generator=g).numpy(),
                                      torch.randn(64, 1, 1000, 128, generator=g).numpy())
                before = {k: b.clone() for k, b in tr.model.named_buffers()}
            with ctx():
                reset_launches()
                m = tr.train_step(*batch)
                torch.cuda.synchronize()
                if label == "kernels":
                    if LAUNCHES:
                        raise AssertionError(f"the RN50 step launched hand-written kernels: {dict(LAUNCHES)}")
                    record_launches(results, "rn50", {})
            trs[label] = (tr, float(m["loss"]))
        (tk, lk), (tp, lp) = trs["kernels"], trs["plain"]
        moved = [k for k, b in tk.model.named_buffers() if not torch.equal(b, before[k])]
        gap = max((b - dict(tp.model.named_buffers())[k]).abs().max().item()
                  for k, b in tk.model.named_buffers())
        del tp, trs
        ms = _step_ms(torch, tk, batch)
        print(f"(b) RN50 VA step B=64: loss {lk:.6f}, plain run {lp:.6f}; {len(moved)} of "
              f"{len(before)} running statistics moved (the frozen image tower's too: "
              f"{sum(k.startswith('image.') for k in moved)}), max |d| to the plain run's {gap:.3e}; "
              f"{ms:.2f} ms/step ({64 / ms * 1e3:.1f} clips/s, {smi}); no hand-written kernel "
              f"(convolutions, BatchNorm and the pool are PyTorch's)")
        if not (np.isfinite(lk) and abs(lk - lp) <= REL * abs(lp) and len(moved) == len(before)
                and gap <= 1e-3):
            raise AssertionError("RN50 step: the loss or the statistics differ from the plain run's")
        results["_rn50_step_ms"] = ms
        del tk, tr, batch
        torch.cuda.empty_cache()
        eng = InferenceEngine(rn50, batch_size=64, seed=0)
        got_a, got_i = eng.embed_audio(audios[:, 0]), eng.embed_images(images)
        with plain_ops():
            want_a, want_i = eng.embed_audio(audios[:, 0]), eng.embed_images(images)
        cos = min(_row_cos(got_a, want_a).min(), _row_cos(got_i, want_i).min())
        t_a = _timed_ms(torch, lambda: eng.embed_audio(audios[:, 0]), 3)
        print(f"(b) RN50 engine at batch 64 (BatchNorm on the stored statistics): min cosine to the "
              f"plain ops {cos:.6f}; embed_audio {t_a:.2f} ms a batch ({smi})")
        if not (np.isfinite(got_a).all() and cos >= COS_MIN):
            raise AssertionError(f"RN50 engine: cosine {cos}")
        del eng
        torch.cuda.empty_cache()

        # (c) patchout: the flagship step at T = 229 against its plain version; a resume
        tr = _trainer(torch, 16, "model.audio.patchout=0.25", f"alias_root={root}", f"model_root={root}",
                      "model_name=patchout")
        batch = _va_batch(tr, np.random.default_rng(6), 16)
        rng_state = tr.state.generator.get_state()
        loss_k, g_k = loss_and_grads(tr.state, *batch)
        tr.state.generator.set_state(rng_state)  # the plain run draws the same patches
        with plain_ops():
            loss_p, g_p = loss_and_grads(tr.state, *batch)
            ref = _trainer(torch, 16, "model.audio.patchout=0.25", "compute_dtype=float32")
            loss_f, g_f = loss_and_grads(ref.state, *batch)
        del ref
        hold_grads_to_fp32(torch, f"(c) patchout B=16 T={PATCHOUT_T}", "patchout VA",
                           (loss_k, g_k), (loss_p, g_p), (loss_f, g_f))
        del g_k, g_p, g_f
        tr.state.generator.set_state(rng_state)
        tr.train_step(*batch)
        tr.global_step = tr.state.step
        tr.save()
        after = [float(tr.train_step(*batch)["loss"]) for _ in range(2)]
        snap = _snapshot(tr)
        resumed = _trainer(torch, 16, "model.audio.patchout=0.25", f"alias_root={root}",
                           f"model_root={root}", "model_name=patchout", "model_file=00000001")
        again = [float(resumed.train_step(*batch)["loss"]) for _ in range(2)]
        diff, what = _resume_diff(torch, resumed, snap)
        print(f"(c) patchout resume from step 1: losses {after} uninterrupted, {again} resumed; "
              f"{what} bitwise: {not diff}")
        if diff or again != after:
            raise AssertionError(f"patchout: the resumed run differs: {sorted(diff)[:5]}")
        del tr, resumed, batch
        torch.cuda.empty_cache()
        tr = _trainer(torch, 64, "model.audio.patchout=0.25")
        batch = _va_batch(tr, np.random.default_rng(7), 64)
        _count_step(torch, tr, batch, _step_launches(24, 12), "patchout", results)
        base = _trainer(torch, 64)
        turns = [_step_ms(torch, t, batch, reps=10) for t in (tr, base, base, tr)]
        busy = [_profile(torch, lambda t=t: t.train_step(*batch))[0] for t in (tr, base)]
        ms = (turns[0] + turns[3]) / 2
        print(f"(c) patchout step B=64 (audio T={PATCHOUT_T} of 306), turns: {turns[0]:.2f}, {turns[3]:.2f} "
              f"ms/step ({64 / ms * 1e3:.1f} clips/s) beside {turns[1]:.2f}, {turns[2]:.2f} without "
              f"patchout; device busy a step {busy[0]:.2f} against {busy[1]:.2f} ms ({smi})")
        results["_patchout_step_ms"] = ms
        del tr, base, batch
        torch.cuda.empty_cache()

        # (d) asynchronous checkpoints: a resume from an async save is the sync-saved run's
        import vipant_tpu_torch.train.trainer as trainer_mod

        data = os.path.join(root, "data")
        write_synthetic_va(data, "train", ASYNC_TRAIN, seed=0)
        write_synthetic_va(data, "val", ASYNC_EVAL, seed=1)
        snaps, issue_ms = {}, {}
        save = trainer_mod.save_checkpoint
        for mode in ("sync", "async"):
            run = os.path.join(root, f"run_{mode}")
            times = []

            def timed(*a, **kw):
                t = time.perf_counter()
                out = save(*a, **kw)
                times.append((time.perf_counter() - t) * 1e3)
                return out

            trainer_mod.save_checkpoint = timed
            try:
                reset_launches()
                a = _loop_trainer(torch, data, run, f"async_ckpt={mode == 'async'}", "running.epochs=1",
                                  "running.eval_name=", "keep_last_ckpts=0")
                a.learn()
                torch.cuda.synchronize()
                record_launches(results, "async", dict(LAUNCHES))
                del a
                b = _loop_trainer(torch, data, run, f"async_ckpt={mode == 'async'}", "running.eval_name=",
                                  "keep_last_ckpts=0", f"model_file={ASYNC_TRAIN // LOOP_B:08d}")
                b.learn()
            finally:
                trainer_mod.save_checkpoint = save
            snaps[mode], issue_ms[mode] = _snapshot(b), times
            del b
            torch.cuda.empty_cache()
        diff = {k: v for k, v in ((k, not torch.equal(p, snaps["sync"][0][k]))
                                  for k, p in snaps["async"][0].items()) if v}
        same_rng = torch.equal(snaps["sync"][2], snaps["async"][2])
        print(f"(d) the VA loop, {ASYNC_TRAIN} clips at B={LOOP_B}, a save at each epoch's end: the save "
              f"call took {[round(t, 1) for t in issue_ms['async']]} ms async (it returns once the state "
              f"is in host memory), {[round(t, 1) for t in issue_ms['sync']]} ms sync ({smi}); the run "
              f"resumed from the async save bitwise the sync-saved run's: {not diff and same_rng}")
        if diff or not same_rng:
            raise AssertionError(f"async checkpoints: the resumed runs differ on {sorted(diff)[:5]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------------- phase 22: the data axis
DP_B, DP_LOOP_TRAIN, DP_LOOP_EVAL, DP_LOOP_B = 64, 64, 32, 32
GC_B, GC_CHUNK, GC_PEAK_B = 128, 64, 256  # the grads held at B = 128 in 2 chunks, peaks at 256 in 4
DP_TIMEOUT = {"nccl_probe": 90, "nccl_one": 180, "ranks": 300, "loop": 300}
DP_LOSS_REL = 1e-3


def _param_hashes(tr):
    """Name -> sha1 of each param's bytes (bitwise comparisons across processes)."""
    import hashlib

    import torch

    return {k: hashlib.sha1(p.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                            .tobytes()).hexdigest()
            for k, p in tr.model.named_parameters()}


def _dp_batch(B, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 3, 224, 224)).astype(np.float32),
            rng.standard_normal((B, 1, 1000, 128)).astype(np.float32))


def _dp_rank_nccl_probe(torch, spec, rank, world, d):
    """Whether NCCL takes two ranks on one device: a sum over both."""
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda:0")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return {"nccl_two_ranks_one_device": f"accepted: {x.tolist()}"}
    except RuntimeError as e:  # the answer this probe is after (DistBackendError is one)
        return {"nccl_two_ranks_one_device": f"refused: {type(e).__name__}: {str(e)[:200]}"}


def _dp_rank_nccl_one(torch, spec, rank, world, d):
    """(a) The flagship step at B = 64 on a one-rank NCCL group."""
    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.train import Trainer

    tr = Trainer(FLAGSHIP + [f"running.batch_size={DP_B}"], device="cuda:0",
                 steps_per_epoch=STEPS_PER_EPOCH)
    batch = tr.make_batch(*_dp_batch(DP_B))
    reset_launches()
    m = tr.train_step(*batch)
    torch.cuda.synchronize()
    return {"mesh": [tr.mesh.data, tr.mesh.backend, tr.mesh.distributed], "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "launches": dict(LAUNCHES), "hashes": _param_hashes(tr)}


def _dp_rank_ranks(torch, spec, rank, world, d):
    """(b) three steps of the flagship on 2 ranks of B = 32 (the first's
    launches counted, its averaged grads saved by rank 0), (c) the same with
    ZeRO-1, a save after its first step, and that save resumed without ZeRO
    for the last two."""
    import os
    import time as _time

    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.parallel import shard_batch
    from vipant_tpu_torch.train import Trainer

    over = FLAGSHIP + [f"running.batch_size={DP_B}"]
    out = {}

    def run(label, *extra, save_after=None, steps=3):
        torch.cuda.empty_cache()
        tr = Trainer(over + list(extra), device="cuda:0", steps_per_epoch=STEPS_PER_EPOCH)
        batch = tr.make_batch(*shard_batch(list(_dp_batch(DP_B)), tr.mesh))
        seen, times, saved = [], [], None
        apply = tr.state.optimizer.apply
        tr.state.optimizer.apply = lambda g: (seen.append(g) if not seen else None, apply(g))[1]
        reset_launches()
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = _time.perf_counter()
            m = tr.train_step(*batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            times.append((_time.perf_counter() - t0) * 1e3)
            if i == 0:
                counts, first = dict(LAUNCHES), (loss, float(m["grad_norm"]))
                if rank == 0 and label == "plain":
                    torch.save({k: g.float().cpu() for k, g in seen[0].items()},
                               os.path.join(d, "grads.pt"))
            tr.global_step += 1
            if save_after == i + 1:
                saved = tr.save()
        out[label] = {"loss": first[0], "grad_norm": first[1], "launches": counts,
                      "ms": times, "state_bytes": tr.state.optimizer.state_bytes(),
                      "hashes": _param_hashes(tr),
                      "backend": tr.mesh.backend}
        return saved

    run("plain")
    saved = run("zero", "mesh.zero=True", f"alias_root={d}/zero", save_after=1)
    run("resumed", f"model_root={os.path.dirname(os.path.dirname(saved))}",
        f"model_file={os.path.basename(saved)}", f"alias_root={d}/resumed", steps=2)
    # which collectives gloo takes on CUDA tensors (the port hands them as they are)
    import torch.distributed as dist

    out["gloo_cuda"] = {}
    for name, op in (("all_reduce", lambda x: dist.all_reduce(x)),
                     ("broadcast", lambda x: dist.broadcast(x, 0)),
                     ("all_gather_into_tensor", lambda x: dist.all_gather_into_tensor(
                         torch.empty(2 * x.numel(), device=x.device), x))):
        try:
            op(torch.ones(4, device="cuda:0"))
            torch.cuda.synchronize()
            out["gloo_cuda"][name] = "takes it"
        except RuntimeError as e:  # the answer this probe is after
            out["gloo_cuda"][name] = f"refuses: {str(e)[:120]}"
    return out


def _dp_rank_loop(torch, spec, rank, world, d):
    """(d) the VA loop on 2 ranks: saves and evals after each of its 2
    steps, then the run resumed from the first save (without the evals)."""
    reports = []

    def learn(*extra):
        from vipant_tpu_torch.train import Trainer

        torch.cuda.empty_cache()
        tr = Trainer(FLAGSHIP + list(spec["loop"]) + list(extra), device="cuda:0")
        infer = tr.infer
        tr.infer = lambda *a, **k: (lambda r: (reports.append([tr.global_step, r]), r)[1])(
            infer(*a, **k))
        tr.learn()
        return tr

    tr = learn(f"alias_root={d}/a")
    out = {"reports": list(reports), "step": tr.global_step, "hashes": _param_hashes(tr),
           "out_dir": tr.out_dir}
    del tr
    re = learn(f"alias_root={d}/b", f"model_root={d}/a", "model_file=00000001", "running.eval_name=")
    out.update(resumed_step=re.global_step, resumed_hashes=_param_hashes(re))
    return out


DP_CASES = {"nccl_probe": ("nccl", 2, _dp_rank_nccl_probe), "nccl_one": ("nccl", 1, _dp_rank_nccl_one),
            "ranks": ("gloo", 2, _dp_rank_ranks), "loop": ("gloo", 2, _dp_rank_loop)}


def dp_rank_main(case, rank, d):
    """One rank of a ``dp_phase`` run (``python3 chip_smoke.py --dp-rank
    <case> <rank> <dir>``): the group of :data:`DP_CASES` through a
    ``FileStore`` in ``d``, both ranks on ``cuda:0``; prints its results as
    one JSON line."""
    import os

    import torch
    import torch.distributed as dist

    from vipant_tpu_torch.ops import _build
    from vipant_tpu_torch.parallel import distributed_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()  # built by the parent: loaded, not rebuilt
    backend, world, fn = DP_CASES[case]
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    distributed_init(backend, device="cuda:0", init_method=f"file://{d}/store", world_size=world,
                     rank=rank, timeout_s=DP_TIMEOUT[case])
    out = fn(torch, spec, rank, world, d)
    print(json.dumps({"rank": rank, "backend": backend, **out}), flush=True)
    if case == "nccl_probe":  # a refused NCCL group may not tear down cleanly
        os._exit(0)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _start_dp(case, root, spec=None):
    """Start every rank of ``case`` as a subprocess of this script, its
    output in a file; :func:`_finish_dp` collects them."""
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix=f"dp_{case}_", dir=root)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec or {}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(DP_CASES[case][1])]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", case, str(r), d],
                              stdout=log, stderr=subprocess.STDOUT, env=env)
             for r, log in enumerate(logs)]
    return case, d, procs, logs, time.perf_counter()


def _finish_dp(run):
    """Each rank's JSON line and the run's directory. A rank that exits
    non-zero or outlives ``DP_TIMEOUT[case]`` fails the phase; every process
    is stopped before this returns."""
    import os

    case, d, procs, logs, t0 = run
    try:
        for p in procs:
            p.wait(timeout=max(DP_TIMEOUT[case] - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"dp_phase {case}: a rank ran past {DP_TIMEOUT[case]} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for r, p in enumerate(procs):
        with open(os.path.join(d, f"rank{r}.log")) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"dp_phase {case}: rank {r} exited {p.returncode}:\n{text[-4000:]}")
        results.append(json.loads(next(line for line in reversed(text.splitlines())
                                       if line.startswith('{"rank"'))))
    print(f"  [{case}: {len(procs)} rank(s) in {time.perf_counter() - t0:.1f} s]")
    return results, d


def _add_launches(results, path, counts):
    for name, n in counts.items():
        r = results.setdefault(name, {"max_abs_err": 0.0, "cases": [], "launches": {}})
        r["launches"][path] = r["launches"].get(path, 0) + n


def dp_phase(torch, results):
    """(a)-(f) of the data axis; see the module docstring."""
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.serve import InferenceEngine
    from vipant_tpu_torch.train import build_monitor, loss_and_grads

    smi = _smi()
    root = tempfile.mkdtemp(prefix="vipant_dp_")
    started = []  # every run's processes, stopped in the end whatever happens

    def start(case, spec=None):
        started.append(_start_dp(case, root, spec))
        return started[-1]

    try:
        torch.cuda.empty_cache()
        runs = [start("nccl_probe"), start("nccl_one")]
        data = os.path.join(root, "va")  # (d)'s index, written while the NCCL runs start
        write_synthetic_va(data, "train", DP_LOOP_TRAIN)
        write_synthetic_va(data, "val", DP_LOOP_EVAL, seed=1)
        probe, _ = _finish_dp(runs[0])
        print(f"NCCL, 2 ranks on cuda:0: {probe[0]['nccl_two_ranks_one_device']}; the 2-rank runs use "
              "gloo on cuda:0; NCCL runs as a group of 1")

        # (a) NCCL, one rank, against the plain training path in this process
        one, _ = _finish_dp(runs[1])
        tr = _trainer(torch, DP_B)
        batch = tr.make_batch(*_dp_batch(DP_B))
        with plain_ops():  # (b)'s plain bf16 grads, at the init
            loss_p, g_p = loss_and_grads(tr.state, *batch)
        reset_launches()
        m = tr.train_step(*batch)
        torch.cuda.synchronize()
        plain_counts, plain_loss = dict(LAUNCHES), float(m["loss"])
        want = _step_launches(24, 12)
        diff = [k for k, v in _param_hashes(tr).items() if one[0]["hashes"][k] != v]
        print(f"(a) {smi}: NCCL group {one[0]['mesh']}: loss {one[0]['loss']:.6f} against the plain "
              f"path's {plain_loss:.6f}; {len(one[0]['hashes']) - len(diff)} of {len(one[0]['hashes'])} "
              f"params bitwise after one step; launches equal: {one[0]['launches'] == plain_counts}")
        if (one[0]["mesh"] != [1, "nccl", True] or diff or one[0]["loss"] != plain_loss
                or one[0]["launches"] != plain_counts or plain_counts != want):
            raise AssertionError(f"(a) the one-rank NCCL step is not the plain step: params {diff[:5]}, "
                                 f"launches {one[0]['launches']} / {plain_counts} / {want}")
        _add_launches(results, "dp", one[0]["launches"])
        one_ms = _step_ms(torch, tr, batch)

        # (b), (c) two ranks of B = 32 on cuda:0, plain and ZeRO-1
        ranks, d = _finish_dp(start("ranks"))
        r0, r1 = ranks
        plain, zero, resumed = r0["plain"], r0["zero"], r0["resumed"]
        rel = abs(plain["loss"] - plain_loss) / abs(plain_loss)
        print(f"(b) {smi}: 2 ranks x B={DP_B // 2} ({plain['backend']}): "
              f"loss {plain['loss']:.6f} against one rank's {plain_loss:.6f} at B={DP_B} "
              f"(rel {rel:.2e}); step ms rank 0 {[round(t, 2) for t in plain['ms']]}, rank 1 "
              f"{[round(t, 2) for t in r1['plain']['ms']]}; one rank at B={DP_B}: {one_ms:.2f} ms "
              "(both ranks share one card: no scaling is measured)")
        if rel > DP_LOSS_REL or r1["plain"]["loss"] != plain["loss"]:
            raise AssertionError(f"(b) the 2-rank loss {plain['loss']} is not the 1-rank {plain_loss}")
        if plain["launches"] != _step_launches(24, 12):
            raise AssertionError(f"(b) a rank's step launches {plain['launches']}")
        _add_launches(results, "dp", plain["launches"])
        split = [k for k, v in plain["hashes"].items() if r1["plain"]["hashes"][k] != v]
        if split:
            raise AssertionError(f"(b) the ranks' params differ after 3 steps: {split[:5]}")
        g_k = {k: v.to("cuda") for k, v in torch.load(os.path.join(d, "grads.pt")).items()}
        loss_k = torch.tensor(plain["loss"])
        del tr
        with plain_ops():
            ref = _trainer(torch, DP_B, "compute_dtype=float32")
            loss_f, g_f = loss_and_grads(ref.state, *ref.make_batch(*_dp_batch(DP_B)))
        del ref
        hold_grads_to_fp32(torch, f"(b) 2 ranks x B={DP_B // 2}", "2-rank", (loss_k, g_k),
                           (loss_p, g_p), (loss_f, g_f))
        del g_k, g_p, g_f
        print(f"  gloo on CUDA tensors: {r0['gloo_cuda']}")
        off = [k for k, v in plain["hashes"].items() if zero["hashes"][k] != v]
        off_resumed = [k for k, v in plain["hashes"].items() if resumed["hashes"][k] != v]
        print(f"(c) {smi}: ZeRO-1 optimizer state bytes: rank 0 {zero['state_bytes']:,}, rank 1 "
              f"{r1['zero']['state_bytes']:,}, without ZeRO {plain['state_bytes']:,} a rank; params "
              f"after 3 steps bitwise the replicated run's: {not off}; a ZeRO save resumed without "
              f"ZeRO bitwise the uninterrupted run: {not off_resumed}; step ms {[round(t, 2) for t in zero['ms']]}")
        if off or off_resumed or not zero["state_bytes"] < plain["state_bytes"]:
            raise AssertionError(f"(c) ZeRO-1: {off[:5]} differ from the replicated run, "
                                 f"{off_resumed[:5]} after the resume")

        # (d) the VA loop on 2 ranks, and a 1-rank eval of its first save
        loop = [f"running.data_root={data}", "running.data_name=train", "running.eval_name=val",
                f"running.batch_size={DP_LOOP_B}", "running.epochs=1", "loader_backend=process",
                "num_proc=2", "running.peep_rate=1", "running.save_rate=1", "running.save_epoch=False",
                "model_name=dploop", "metrics_jsonl=True"]
        loop_run = start("loop", {"loop": loop + ["eval=False"]})

        # (e) the gradient cache at full width: the grads while the loop runs, the times after it
        reset_launches()
        gc = _trainer(torch, GC_B, "running.grad_cache.alive=True",
                      f"running.grad_cache.chunk_size={GC_CHUNK}")
        seen = []
        apply = gc.state.optimizer.apply
        gc.state.optimizer.apply = lambda g: (seen.append(g), apply(g))[1]
        batch = gc.make_batch(*_dp_batch(GC_B, seed=13))
        reset_launches()
        loss_k = gc.train_step(*batch)["loss"]
        torch.cuda.synchronize()
        n = GC_B // GC_CHUNK
        # both towers a chunk without grad, then the audio tower's re-forward a chunk
        counts, want = dict(LAUNCHES), _step_launches(36 * n, 12 * n, 3 * n)
        if gc.grad_cache != (("encode_image", "encode_audio"), n) or counts != want:
            raise AssertionError(f"(e) the VA gradient-cache step: {gc.grad_cache}, launches {counts} "
                                 f"!= {want}")
        _add_launches(results, "grad_cache", counts)
        g_k = seen[0]
        del gc, seen
        tr = _trainer(torch, GC_B)
        loss_p, g_p = loss_and_grads(tr.state, *batch)
        del tr
        with plain_ops():
            ref = _trainer(torch, GC_B, "compute_dtype=float32")
            loss_f, g_f = loss_and_grads(ref.state, *batch)
        del ref
        hold_grads_to_fp32(torch, f"(e) VA B={GC_B} in {n} chunks of {GC_CHUNK}", "gradient-cache",
                           (loss_k, g_k), (loss_p, g_p), (loss_f, g_f))
        del g_k, g_p, g_f, batch
        la = _la_monitor(torch, "running.grad_cache.alive=True", f"running.grad_cache.chunk_size={LA_B // 2}",
                         steps_per_epoch=STEPS_PER_EPOCH)
        seen = []
        apply = la.state.optimizer.apply
        la.state.optimizer.apply = lambda g: (seen.append(g), apply(g))[1]
        batch = _la_batch(la, np.random.default_rng(15), LA_B)
        reset_launches()
        loss_k = la.train_step(*batch)["loss"]
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        trains = [t for t in ("audio", "text") if any(p.requires_grad for p in getattr(la.model, t).parameters())]
        layers = {t: len(getattr(la.model, t).encoder.resblocks) for t in ("audio", "text")}
        want = _step_launches(2 * sum(layers.values()) + 2 * sum(layers[t] for t in trains),
                              2 * sum(layers[t] for t in trains), 2 + 2 * ("audio" in trains))
        if la.grad_cache != (("encode_audio", "encode_text"), 2) or counts != want:
            raise AssertionError(f"(e) the AT gradient-cache step: {la.grad_cache}, launches {counts} "
                                 f"!= {want}")
        _add_launches(results, "grad_cache", counts)
        g_k = seen[0]
        del la, seen
        plain_la = _la_monitor(torch, steps_per_epoch=STEPS_PER_EPOCH)
        loss_p, g_p = loss_and_grads(plain_la.state, *batch)
        del plain_la
        with plain_ops():
            ref = _la_monitor(torch, "compute_dtype=float32", steps_per_epoch=STEPS_PER_EPOCH)
            loss_f, g_f = loss_and_grads(ref.state, *batch)
        del ref
        hold_grads_to_fp32(torch, f"(e) AT B={LA_B} in 2 chunks", "AT gradient-cache", (loss_k, g_k),
                           (loss_p, g_p), (loss_f, g_f))
        del g_k, g_p, g_f

        # (f) the engine's data_parallel on one card
        engines = [InferenceEngine(CLAP_FULL, batch_size=BATCH, seed=0, data_parallel=dp)
                   for dp in (False, True)]
        rng = np.random.default_rng(16)
        fb = rng.standard_normal((6, 1000, 128)).astype(np.float32)
        outs = [(e.embed_audio(fb), e.embed_texts(PROMPTS)) for e in engines]
        same = all(np.array_equal(x, y) for x, y in zip(*outs))
        print(f"(f) {smi}: InferenceEngine(data_parallel=True) on {torch.cuda.device_count()} card: "
              f"{len(engines[1].replicas)} replica, embeddings bitwise the engine without it: {same}")
        if not same or len(engines[1].replicas) != torch.cuda.device_count():
            raise AssertionError("(f) data_parallel on one card changed the engine")
        del engines

        # (d) the loop's checks
        lp, d = _finish_dp(loop_run)
        a, b = lp
        torch.cuda.empty_cache()
        evaluator = build_monitor(FLAGSHIP + loop + ["eval=True", f"alias_root={root}/one",
                                                     f"model_root={os.path.dirname(a['out_dir'])}",
                                                     "model_file=00000001"])
        report = evaluator.learn()
        del evaluator
        print(f"(d) {smi}: the loop's steps {a['step']}, its resume's {a['resumed_step']}; rank 0's "
              f"report after the first save: {a['reports'][0][1]}; one rank's eval of that "
              f"checkpoint: {report}")
        if not (a["step"] == b["step"] == a["resumed_step"] == DP_LOOP_TRAIN // DP_LOOP_B
                and [s for s, _ in a["reports"]] == [1, 2] and a["reports"][0][1] == report
                and a["hashes"] == b["hashes"] == a["resumed_hashes"] == b["resumed_hashes"]):
            raise AssertionError("(d) the 2-rank loop: steps, reports or resumed params differ")

        peaks, ms = {}, {}
        for label, extra in (("plain", ()), ("grad_cache", ("running.grad_cache.alive=True",
                                                             f"running.grad_cache.chunk_size={GC_CHUNK}"))):
            tr = _trainer(torch, GC_PEAK_B, *extra)
            batch = tr.make_batch(*_dp_batch(GC_PEAK_B, seed=14))
            tr.train_step(*batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms[label] = _step_ms(torch, tr, batch, reps=2)
            peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
            del tr, batch
            torch.cuda.empty_cache()
        print(f"(e) {smi}: VA at B={GC_PEAK_B}: plain {ms['plain']:.2f} ms, peak {peaks['plain']:.2f} GiB; "
              f"gradient cache in {GC_PEAK_B // GC_CHUNK} chunks of {GC_CHUNK}: {ms['grad_cache']:.2f} ms, "
              f"peak {peaks['grad_cache']:.2f} GiB")
        if not peaks["grad_cache"] < peaks["plain"]:
            raise AssertionError(f"(e) the gradient cache's peak {peaks} is not the lower")
    finally:
        for _, _, procs, logs, _ in started:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        shutil.rmtree(root, ignore_errors=True)


MP_B, MP_MICRO, MP_SERVE_B, MP_CAPTION_B = 16, 4, 64, 4
MP_TIMEOUT = {"mp_probe": 60, "mp": 600}
MP_LOSS_REL = 1e-2  # (a)-(c): the loss and grad norm against the one-rank kernel step
MP_AXES = (("model", ["mesh.model=2"]), ("pipe", ["mesh.pipe=2", f"mesh.microbatches={MP_MICRO}"]),
           ("seq", ["mesh.seq=2"]))
# the kernels each axis's step launches: every kernel of the sub-blocks' chains on the model and pipe
# axes; on the seq axis the attention leaves for the ring (plain products), its LayerNorm and
# products and the whole MLP chain stay on the kernels
MP_KERNELS = {
    "model": ("layernorm_fwd", "gemm_bias_act", "attention_fwd", "layernorm_bwd", "gemm_dgrad",
              "gemm_wgrad", "colsum", "attention_bwd", "fused_ln_attention_block",
              "fused_ln_attention_block_bwd", "fused_ln_mlp_block", "fused_ln_mlp_block_bwd"),
    "seq": ("layernorm_fwd", "gemm_bias_act", "layernorm_bwd", "gemm_dgrad", "gemm_wgrad", "colsum",
            "fused_ln_mlp_block", "fused_ln_mlp_block_bwd"),
}
MP_KERNELS["pipe"] = MP_KERNELS["model"]
MP_INT8_KERNELS = ("layernorm_rowquant", "rowquant", "gemm_i8", "attention_fwd_f32",
                   "fused_ln_attention_block_int8", "fused_ln_mlp_block_int8")


def _mp_rank_probe(torch, spec, rank, world, d):
    """(e) What gloo does with CUDA tensors beyond the data axis's three collectives:
    a bf16 all-reduce and a point-to-point send and receive, each printed as
    soon as it returns (a crash leaves the lines before it)."""
    import torch.distributed as dist

    out = {}

    def report(key, value):
        out[key] = value
        print(json.dumps({"rank": rank, "probe": out}), flush=True)

    x = torch.full((4,), 1.5 + rank, dtype=torch.bfloat16, device="cuda:0")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        report("all_reduce_bf16", f"takes it: {x.float().tolist()}")
    except RuntimeError as e:  # the answer this probe is after
        report("all_reduce_bf16", f"refuses: {str(e)[:160]}")
    t = torch.arange(4, dtype=torch.float32, device="cuda:0") + 10 * (rank + 1)
    got = torch.zeros(4, device="cuda:0")
    try:
        reqs = [dist.isend(t, 1 - rank), dist.irecv(got, 1 - rank)]
        for r in reqs:
            r.wait()
        torch.cuda.synchronize()
        want = torch.arange(4, dtype=torch.float32, device="cuda:0") + 10 * (2 - rank)
        report("isend_irecv_cuda", "takes it, " + ("right" if torch.equal(got, want) else
                                                  f"WRONG data {got.tolist()}"))
    except RuntimeError as e:
        report("isend_irecv_cuda", f"refuses: {str(e)[:160]}")
    return {"probe": out}


def _mp_full(tr, tensors, names):
    return {k: v.float() for k, v in tr.placement.full(dict(tensors), names).items()}


def _full_hashes(tr):
    """sha1 of every full parameter (trainable and frozen) of a split trainer:
    a collective."""
    import hashlib

    import torch

    full = {**tr.placement.full(tr.trainable, tr.full_names[0]),
            **tr.placement.full(tr.frozen, tr.full_names[1])}
    return {k: hashlib.sha1(v.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                            .tobytes()).hexdigest() for k, v in full.items()}


def _mp_rank(torch, spec, rank, world, d):
    """(a)-(c) the flagship step at B = 16 on each axis of 2, on the kernels
    in bf16 and on the plain ops in fp32, against the parent's one-rank steps
    (``ref.pt``), a save after the kernel step, the run's second step and a
    resume's; (d) the model-parallel engines."""
    import contextlib
    import io
    import os
    import time as _time

    from vipant_tpu_torch.ops import LAUNCHES, reset_launches
    from vipant_tpu_torch.parallel import shard_batch
    from vipant_tpu_torch.serve import InferenceEngine
    from vipant_tpu_torch.train import Trainer, loss_and_grads, reduce_grads

    ref = torch.load(os.path.join(d, "ref.pt"), map_location="cuda:0")
    out = {}
    for axis, extra in MP_AXES:
        torch.cuda.empty_cache()
        over = FLAGSHIP + [f"running.batch_size={MP_B}", "mesh.data=-1", *extra]
        # the fp32 step on the plain ops: every grad against the one-rank fp32 step's
        with plain_ops():
            tr = Trainer(over + ["compute_dtype=float32"], device="cuda:0", steps_per_epoch=STEPS_PER_EPOCH)
            loss32, g32 = loss_and_grads(tr.state, *tr.make_batch(*shard_batch(list(_dp_batch(MP_B, seed=21)),
                                                                                tr.mesh)))
        g32 = _mp_full(tr, reduce_grads(tr.state, g32), tr.full_names[0])
        cos32 = {k: _cos(torch, g32[k], ref["F"][k]) for k in ref["F"]}
        del tr, g32
        torch.cuda.empty_cache()
        # the step on the kernels
        tr = Trainer(over + [f"alias_root={d}/{axis}"], device="cuda:0", steps_per_epoch=STEPS_PER_EPOCH)
        batch = tr.make_batch(*shard_batch(list(_dp_batch(MP_B, seed=21)), tr.mesh))
        seen = []
        apply = tr.state.optimizer.apply
        tr.state.optimizer.apply = lambda g: (seen.append(g) if not seen else None, apply(g))[1]
        reset_launches()
        ms = []
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        m = tr.train_step(*batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        ms.append((_time.perf_counter() - t0) * 1e3)
        counts = dict(LAUNCHES)
        grads = _mp_full(tr, seen[0], tr.full_names[0])
        seen.clear()
        cos = {k: _cos(torch, grads[k], ref["K"][k]) for k in ref["K"]}
        report, held = io.StringIO(), True
        if rank == 0:  # the axis's kernel step no further from fp32 than the one-rank kernel step
            with contextlib.redirect_stdout(report):
                try:
                    hold_grads_to_fp32(torch, f"  {axis}=2 kernels (K below) against one rank's kernels "
                                       "(P below) and fp32", f"mesh.{axis}=2", (loss, grads),
                                       (ref["loss"], ref["K"]), (ref["loss_f"], ref["F"]))
                except AssertionError as e:
                    held = False
                    print(f"    {e}")
        del grads
        tr.global_step += 1
        saved = tr.save()
        at_save = _full_hashes(tr)
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        tr.train_step(*batch)
        torch.cuda.synchronize()
        ms.append((_time.perf_counter() - t0) * 1e3)
        tr.global_step += 1
        after = _full_hashes(tr)
        local = sum(p.numel() for p in tr.trainable.values())
        del tr
        torch.cuda.empty_cache()
        re = Trainer(over + [f"alias_root={d}/{axis}_re", f"model_root={os.path.dirname(os.path.dirname(saved))}",
                             f"model_file={os.path.basename(saved)}"], device="cuda:0",
                     steps_per_epoch=STEPS_PER_EPOCH)
        re.train_step(*batch)
        resumed = _full_hashes(re)
        del re, batch
        out[axis] = {"loss": loss, "grad_norm": gnorm, "loss32": float(loss32), "ms": ms, "launches": counts,
                     "cos": cos, "cos32": cos32, "held": held, "report": report.getvalue(), "saved": saved,
                     "at_save": at_save if rank == 0 else None, "resumed_bitwise": resumed == after,
                     "local_params": local}
    # (d) the engines on the model axis: CLAP at batch 64 in bf16 and int8, the captioning decoder
    fb = np.random.default_rng(22).standard_normal((MP_SERVE_B, 1000, 128)).astype(np.float32)
    texts = [PROMPTS[i % len(PROMPTS)] + f" {i}" for i in range(MP_SERVE_B)]
    serve = {}
    for quantize in ("", "int8"):
        torch.cuda.empty_cache()
        eng = InferenceEngine(CLAP_FULL, batch_size=MP_SERVE_B, seed=0, quantize=quantize,
                              model_parallel=world, device="cuda:0")
        reset_launches()
        a, t = eng.embed_audio(fb), eng.embed_texts(texts)
        counts = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        eng.embed_audio(fb)
        torch.cuda.synchronize()
        serve[quantize or "bf16"] = {"audio_ms": (_time.perf_counter() - t0) * 1e3, "launches": counts}
        np.save(os.path.join(d, f"mp_{quantize or 'bf16'}_audio_{rank}.npy"), a)
        np.save(os.path.join(d, f"mp_{quantize or 'bf16'}_text_{rank}.npy"), t)
        del eng
    torch.cuda.empty_cache()
    cap = InferenceEngine(CAPTION_FULL, batch_size=MP_CAPTION_B, seed=0, model_parallel=world,
                          device="cuda:0")
    fb4 = fb[:MP_CAPTION_B]
    with torch.inference_mode():
        _, logits = cap.model.decode(torch.from_numpy(fb4[:, None]).to("cuda:0"))
    np.save(os.path.join(d, f"mp_caption_logits_{rank}.npy"), logits[:, 0].float().cpu().numpy())
    torch.cuda.synchronize()
    t0 = _time.perf_counter()
    serve["captions"] = cap.caption(fb4)
    torch.cuda.synchronize()
    serve["caption_ms"] = (_time.perf_counter() - t0) * 1e3
    out["serve"] = serve
    return out


DP_CASES.update({"mp_probe": ("gloo", 2, _mp_rank_probe), "mp": ("gloo", 2, _mp_rank)})
DP_TIMEOUT.update(MP_TIMEOUT)


def _finish_probe(run):
    """The probe's ranks' last lines and exit codes; a rank that crashes or
    hangs is the probe's answer, not a failure (every process is stopped)."""
    import os

    case, d, procs, logs, t0 = run
    try:
        for p in procs:
            try:
                p.wait(timeout=max(MP_TIMEOUT[case] - (time.perf_counter() - t0), 1.0))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    found = []
    for r, p in enumerate(procs):
        with open(os.path.join(d, f"rank{r}.log")) as f:
            lines = [ln for ln in f.read().splitlines() if ln.startswith('{"rank"')]
        found.append({"exit": p.returncode, **(json.loads(lines[-1])["probe"] if lines else {})})
    return found


def mp_phase(torch, results):
    """(a)-(e) of the model, pipe and seq axes and model-parallel serving; see
    the module docstring."""
    import os
    import shutil
    import tempfile

    from vipant_tpu_torch.serve import InferenceEngine
    from vipant_tpu_torch.train import Trainer, loss_and_grads

    smi = _smi()
    root = tempfile.mkdtemp(prefix="vipant_mp_")
    started = []

    def start(case, spec=None):
        started.append(_start_dp(case, root, spec))
        return started[-1]

    try:
        probe = start("mp_probe")
        # the one-rank kernel step the axes are held to, and the one-rank engines
        tr = _trainer(torch, MP_B)
        batch = tr.make_batch(*_dp_batch(MP_B, seed=21))
        seen = []
        apply = tr.state.optimizer.apply
        tr.state.optimizer.apply = lambda g: (seen.append(g), apply(g))[1]
        m = tr.train_step(*batch)
        one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        with plain_ops():
            f = _trainer(torch, MP_B, "compute_dtype=float32")
            loss_f, g_f = loss_and_grads(f.state, *f.make_batch(*_dp_batch(MP_B, seed=21)))
        d = os.path.join(root, "mp")
        os.makedirs(d)
        torch.save({**one, "K": {k: g.float().cpu() for k, g in seen[0].items()},
                    "loss_f": float(loss_f), "F": {k: g.float().cpu() for k, g in g_f.items()}},
                   os.path.join(d, "ref.pt"))
        del f, g_f
        one_ms = _step_ms(torch, tr, batch, reps=2)
        del tr, seen, batch
        found = _finish_probe(probe)
        print(f"(e) {smi}: gloo with CUDA tensors on cuda:0, beyond all_reduce / broadcast / "
              f"all_gather: {found}; the port's point-to-point (pipeline, ring) goes through "
              "collectives.host_staged_exchange (pinned host buffers) on gloo, and its bf16 sums are "
              "widened to fp32 on gloo's wire")
        run = _start_dp_in("mp", d)
        started.append(run)
        fb = np.random.default_rng(22).standard_normal((MP_SERVE_B, 1000, 128)).astype(np.float32)
        texts = [PROMPTS[i % len(PROMPTS)] + f" {i}" for i in range(MP_SERVE_B)]
        ref_serve = {}
        for quantize in ("", "int8"):
            eng = InferenceEngine(CLAP_FULL, batch_size=MP_SERVE_B, seed=0, quantize=quantize)
            ref_serve[quantize or "bf16"] = (eng.embed_audio(fb), eng.embed_texts(texts))
            del eng
        cap = _caption_engine(torch, MP_CAPTION_B)
        with torch.inference_mode():
            _, logits = cap.model.decode(torch.from_numpy(fb[:MP_CAPTION_B, None]).to("cuda"))
        ref_logits, ref_caps = logits[:, 0].float().cpu().numpy(), cap.caption(fb[:MP_CAPTION_B])
        del cap, logits
        torch.cuda.empty_cache()
        ranks, _ = _finish_dp(run)
        for axis, _ in MP_AXES:
            r0, r1 = ranks[0][axis], ranks[1][axis]
            rel = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
            rel_n = abs(r0["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
            rel32 = abs(r0["loss32"] - loss_f) / abs(loss_f)
            low32 = sorted((c, k) for k, c in r0["cos32"].items() if not c >= COS_MIN)
            label = {"model": "(a) mesh.model=2", "pipe": f"(b) mesh.pipe=2, {MP_MICRO} microbatches",
                     "seq": "(c) mesh.seq=2"}[axis]
            print(f"{label} {smi}: 2 gloo ranks on cuda:0, B={MP_B}: the kernel step's loss "
                  f"{r0['loss']:.6f} against one rank's {one['loss']:.6f} (rel {rel:.2e}), grad norm "
                  f"{r0['grad_norm']:.6f} against {one['grad_norm']:.6f} (rel {rel_n:.2e}); per-grad cosine to "
                  f"one rank's kernel grads: min {min(r0['cos'].values()):.6f}, "
                  f"{sum(c >= COS_MIN for c in r0['cos'].values())} of {len(r0['cos'])} >= {COS_MIN} (bf16: "
                  f"held to fp32 below); the fp32 plain step's loss rel {rel32:.2e}, "
                  f"{len(r0['cos32']) - len(low32)} of {len(r0['cos32'])} grads at cosine >= {COS_MIN} to "
                  f"one rank's fp32 grads (lowest {min(r0['cos32'].values()):.6f}); step ms rank 0 "
                  f"{[round(t, 2) for t in r0['ms']]}, rank 1 {[round(t, 2) for t in r1['ms']]} (one rank: "
                  f"{one_ms:.2f} ms; gloo through host memory on one shared card: no scaling is measured); "
                  f"trainable params a rank {r0['local_params']:,} / {r1['local_params']:,}; resume bitwise: "
                  f"{r0['resumed_bitwise']} / {r1['resumed_bitwise']}")
            print(r0["report"], end="")
            for r, x in enumerate((r0, r1)):
                print(f"  rank {r} launches: {x['launches']}")
            missing = [k for k in MP_KERNELS[axis] for x in (r0, r1) if not x["launches"].get(k)]
            if (rel > MP_LOSS_REL or rel_n > MP_LOSS_REL or rel32 > MP_LOSS_REL or low32 or missing
                    or not r0["held"]):
                raise AssertionError(f"{label}: loss rel {rel:.2e}, grad norm rel {rel_n:.2e}, fp32 loss "
                                     f"rel {rel32:.2e}, fp32 grads below {COS_MIN}: {low32[:5]}, kernels "
                                     f"not launched: {missing}, kernel grads held to fp32: {r0['held']}")
            if not (r0["resumed_bitwise"] and r1["resumed_bitwise"]):
                raise AssertionError(f"{label}: the resumed step is not bitwise the run's")
            _add_launches(results, f"mp_{axis}", r0["launches"])
            torch.cuda.empty_cache()
            one_rank = Trainer(FLAGSHIP + [f"running.batch_size={MP_B}", f"alias_root={root}/one_{axis}",
                                           f"model_root={os.path.dirname(os.path.dirname(r0['saved']))}",
                                           f"model_file={os.path.basename(r0['saved'])}"],
                               steps_per_epoch=STEPS_PER_EPOCH)
            off = [k for k, v in _param_hashes(one_rank).items() if r0["at_save"].get(k) != v]
            print(f"  the {axis} save in a one-rank trainer: {len(r0['at_save']) - len(off)} of "
                  f"{len(r0['at_save'])} params bitwise the gathered ones")
            if off or len(r0["at_save"]) != len(_param_hashes(one_rank)):
                raise AssertionError(f"{label}: the save loads into one rank with {off[:5]} off")
            del one_rank
        serve = ranks[0]["serve"]
        for mode in ("bf16", "int8"):
            a_ref, t_ref = ref_serve[mode]
            for r in range(2):
                a = np.load(os.path.join(d, f"mp_{mode}_audio_{r}.npy"))
                t = np.load(os.path.join(d, f"mp_{mode}_text_{r}.npy"))
                ca, ct = _row_cos(a, a_ref).min(), _row_cos(t, t_ref).min()
                print(f"(d) {smi}: InferenceEngine(model_parallel=2) {mode} rank {r}: embed_audio x"
                      f"{MP_SERVE_B} cosine to one rank >= {ca:.6f}, embed_texts >= {ct:.6f}"
                      + (f"; {serve[mode]['audio_ms']:.2f} ms a batch of {MP_SERVE_B}" if r == 0 else ""))
                if not (ca >= COS_MIN and ct >= COS_MIN):
                    raise AssertionError(f"(d) {mode} rank {r}: cosine {ca}, {ct} to one rank")
            _add_launches(results, "mp_serve" if mode == "bf16" else "mp_serve_int8", serve[mode]["launches"])
        for r in range(2):
            a8, a16 = (np.load(os.path.join(d, f"mp_{m}_audio_{r}.npy")) for m in ("int8", "bf16"))
            t8, t16 = (np.load(os.path.join(d, f"mp_{m}_text_{r}.npy")) for m in ("int8", "bf16"))
            c8 = min(_row_cos(a8, a16).min(), _row_cos(t8, t16).min())
            if not c8 >= INT8_COS_MIN:
                raise AssertionError(f"(d) rank {r}: int8 against bf16 cosine {c8}")
        missing = [k for k in MP_INT8_KERNELS if not serve["int8"]["launches"].get(k)]
        if missing:
            raise AssertionError(f"(d) int8 kernels not launched: {missing}")
        for r in range(2):
            lg = np.load(os.path.join(d, f"mp_caption_logits_{r}.npy"))
            cl = _row_cos(lg, ref_logits).min()
            print(f"(d) rank {r}: greedy caption at batch {MP_CAPTION_B}, the first step's logits cosine "
                  f"to one rank >= {cl:.6f}" + (f"; captions equal to one rank's: "
                                                f"{serve['captions'] == ref_caps}, {serve['caption_ms']:.2f} ms"
                                                if r == 0 else ""))
            if not cl >= COS_MIN:
                raise AssertionError(f"(d) caption logits rank {r}: cosine {cl}")
    finally:
        for _, _, procs, logs, _ in started:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        shutil.rmtree(root, ignore_errors=True)


def _start_dp_in(case, d):
    """:func:`_start_dp` in the directory ``d`` the parent has filled."""
    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump({}, f)
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(DP_CASES[case][1])]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", case, str(r), d],
                              stdout=log, stderr=subprocess.STDOUT, env=env)
             for r, log in enumerate(logs)]
    return case, d, procs, logs, time.perf_counter()


PHASES = (
    ("kernel_phase", "kernel phase (forward kernels vs plain PyTorch on the card)", kernel_phase),
    ("backward_kernel_phase", "backward kernel phase (vs plain PyTorch on the card)",
     backward_kernel_phase),
    ("slice_phase", "serving slice (full-size CLAP engine)", slice_phase),
    ("train_phase", "training slice (flagship VA step, full width)", train_phase),
    ("int8_kernel_phase", "int8 kernel phase (vs plain PyTorch on the card)", int8_kernel_phase),
    ("int8_serve_phase", "int8 serving slice (full-size CLAP engine, quantize=int8)", int8_serve_phase),
    ("train_int8_phase", "training slice with the int8 frozen image tower", train_int8_phase),
    ("flash_kernel_phase", "flash kernel phase (vs plain PyTorch on the card)", flash_kernel_phase),
    ("probe_phase", "probe phase (dot variants, fused forward probe)", probe_phase),
    ("caption_train_phase", "captioning training slice (full width, 12 + 12 layers)", caption_train_phase),
    ("caption_serve_phase", "captioning serving slice (InferenceEngine.caption)", caption_serve_phase),
    ("loop_phase", "VA epoch loop (full width)", loop_phase),
    ("la_phase", "AT fine-tuning (LAMonitor, full width)", la_phase),
    ("frontend_phase", "the device frontend and serving from files (full width)", frontend_phase),
    ("ckpt_phase", "checkpoint loading and export (a full-width synthetic CLIP file)", ckpt_phase),
    ("clf_phase", "classification (ESC-50 x-fold, AudioSet, full width)", clf_phase),
    ("pak_phase", "packed shards (pak VA, AT and AudioSet; the one-gather batch path)", pak_phase),
    ("trimodal_phase", "trimodal, siamese and Barlow training (full width)", trimodal_phase),
    ("backbone_phase", "the other backbones (DeiT, RN50), patchout and asynchronous checkpoints "
     "(full width)", backbone_phase),
    ("dp_phase", "the data axis: NCCL, 2 ranks, ZeRO-1, the loop, the gradient cache, data-parallel "
     "serving (full width)", dp_phase),
    ("mp_phase", "the model, pipe and seq axes and model-parallel serving (full width, 2 gloo ranks)",
     mp_phase),
)


def main(argv=None) -> int:
    """``python3 chip_smoke.py [phase ...]``: the named phases of
    :data:`PHASES` in their order, or all of them."""
    names = sys.argv[1:] if argv is None else list(argv)
    if names[:1] == ["--dp-rank"]:  # one rank of dp_phase's runs
        return dp_rank_main(names[1], int(names[2]), names[3])
    known = [name for name, _, _ in PHASES]
    unknown = [n for n in names if n not in known]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase(s) {unknown}; the phases: {' '.join(known)}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    from vipant_tpu_torch.ops import _build  # fails outside a checkout of the repo

    print(_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({_build.build_dir()})")
    log = (_build.build_dir() / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  " + line.strip())

    results: dict = {}
    ran = [name for name in known if not names or name in names]
    for name, title, phase in PHASES:
        if name not in ran:
            continue
        t0 = time.perf_counter()
        print(title + ":")
        phase(torch, results)
        print(f"  ({time.perf_counter() - t0:.1f} s)")

    whole = len(ran) == len(PHASES)
    line = {"kernels": []} if whole else {"phases": ran, "kernels": []}
    for name, (source, replaces) in KERNELS.items():
        r = results.get(name)
        if r is None and not whole:  # a kernel the selected phases do not reach
            continue
        if whole and (r is None or not any(r["launches"].values())):
            raise AssertionError(f"{name} was launched on no main path")
        main_case = r["cases"][0] if r["cases"] else {}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r["launches"].values()),
            "launches_by_path": {path: r["launches"].get(path, 0) for path in PATHS},
            "max_abs_err": r["max_abs_err"], "ms": main_case.get("ms"),
            "plain_ms": main_case.get("plain_ms"), "bound_ms": main_case.get("bound_ms"),
            "bound_by": main_case.get("bound_by"), "library_ms": main_case.get("library_ms"),
            "cases": r["cases"],
        })
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
