"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Preconditions and build: a CUDA device must be present; every kernel
   source (``ops/kernels/csrc/*.cu``) is compiled from this checkout, one
   nvcc process per source, all started together, into one library.
2. HiFi-GAN tail kernel (K1; its residual units split TF32 on the tensor
   cores) against its plain PyTorch version at the HiFi-GAN v1 tail shapes
   (B=1, T0=32768, C0=128: the tail of a 512-frame decode) and on one
   ragged case (B=2, T0=1000), on decode's weights and on random weights
   of gain one at the same shapes, max |diff| <= 2e-4 and <= 1e-4
   max|plain|, two runs (and a run that splits its weights) bit for bit,
   with a neighbouring dilation's split and the split's lo halves zeroed
   as controls that the check must reject on the latter; CUDA-event times with the weights'
   split that decode keeps and splitting per call, beside the bounds at
   the split-TF32 and float32 rates; a torch.profiler split of one call
   by kernel; the residual-unit kernels' registers, spills and SASS counts
   (``ops/kernels/sass.py``); the HiFi-GAN v1 forward at 512 frames with
   the tail and without.
3. HiFi-GAN v1 decode through ``parallelwavegan_tpu_torch.bin.decode.main``:
   a random-init, full-width checkpoint, stats and a 3-utterance npy dump
   directory are written to a scratch directory in the checkout and
   decoded with ``--use-pallas-tail`` (the kernel must launch once per
   utterance, every residual unit on the tensor cores) and again with the
   tail off; the two must agree to 2e-4.
4. The WaveNet layer kernel against its plain version at Parallel WaveGAN
   v1 widths (residual 64, gate 128, skip 64, aux 80): one dilation cycle
   (1..512) at B=1, T=131072 (512 frames) with CUDA-event times (with the
   weights' split that decode keeps, and splitting per call) beside its
   bounds at the split-TF32 and float32 rates, a ragged cycle (B=2,
   T=1000, the d=512 halo past both ends), and single layers (K5) at the
   main path's shapes, non-causal d=1 and d=512 at T=131072 (timed at
   d=1), and non-causal d=1 and causal d=4 at T=777; each within 2e-4 and
   1e-4 max|plain|, two runs bit for bit, with a neighbouring layer's
   split and (for the cycles) the columns unpaired as controls that the
   check must reject; a torch.profiler split of one cycle (the layers
   apart from the weight split), and the kernel's registers, spills and
   SASS counts (``ops/kernels/sass.py``).
5. The split of the Parallel WaveGAN v1 forward at 512 frames: upsample
   net, the 30 layers with and without the kernel, the last convs, and the
   whole forward with and without it.
6. Parallel WaveGAN v1 decode through ``bin/decode.main``: a random-init,
   full-width checkpoint with ``generator_params`` verbatim from
   egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml (its
   ``use_pallas_stack_train: true`` alone routes the 30 layers through the
   kernel: 30 launches per utterance), then with ``use_pallas_kernels``
   instead (the one-layer call: 30 launches per utterance), then with
   every kernel flag off, each with the same noise; the WAVs agree to 2e-4.
7. The MelGAN stack kernel (K6; split TF32 on the tensor cores) against
   its plain version, max |diff| <= 2e-4 and <= 1e-4 max|plain|, two runs
   (and a run that splits its weights) bit for bit: Multi-band MelGAN
   v2's stage 1 (B=1, T=16384, C=96, 4 stacks, reflect) and stage 2 with
   the final conv (B=1, T=32768, C=48 -> 4, tanh) at 512 frames, on
   decode's weights and on random weights of gain one, with the split's
   lo halves zeroed as a control that the check must reject on the
   latter; ragged B=2, T=1000, C=64 cases in replicate and zero padding, a
   padding too wide for one window (C=128, d=130: the taps staged one at a
   time) and MelGAN v1's training stages (B=8); CUDA-event times of one
   decode's K6 with the split that decode keeps and splitting per call,
   beside its bounds at the split-TF32 and float32 rates, a torch.profiler
   split by kernel, the v1 training forward's K6 beside its plain version,
   K6's weight-split kernel bit for bit against its plain version
   (``tf32x3.stack_forward_fragments``) at every case's weights,
   and the kernels' registers, spills and SASS counts
   (``ops/kernels/sass.py``: HMMA.1688.F32.TF32 and no FFMA in the stack
   kernel, or the phase fails).
8. The MRF kernel (K2) against its plain version: HiFi-GAN v1's stage 2
   and 3 shapes (1, 65536, 64) and (1, 131072, 32), stage 1's (1, 32768,
   128) (the width ``pallas_mrf_max_channels: 128`` sends), and a ragged
   B=2, T=1000 case, each within 2e-4 and 1e-4 max|plain|, bit for bit in
   two runs, on decode's weights and on random weights of gain one, with
   phase 2's two controls rejected on the latter; times with the split
   kept and per call, beside both bounds.
9. The split of the MB-MelGAN v2 forward at 512 frames: input conv and
   stage 0, stage 1, stage 2 with the final conv (each with and without
   K6), and PQMF synthesis.
10. MB-MelGAN v2 decode through ``bin/decode.main``: a random-init,
   full-width checkpoint with ``generator_params`` verbatim from
   egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml, decoded with
   ``--use-pallas-stacks`` (K6 called twice per utterance, 9 launches;
   its weight split launched once per stage when the model is loaded,
   never per utterance) and without; the WAVs agree to 2e-4.

11. The TADE kernels (K8a, K8b) against their plain versions at
   StyleMelGAN v1's blocks 3-8 of a 512-frame decode (B=1, T = 5632 ..
   180224, scales 2 then 1, d=2, softmax), each timed beside its plain
   version and bounds (at the split-TF32 tensor-core rate they multiply
   at, and at the float32 CUDA-core rate), the six-block chain too, and
   ragged cases (B=2, T=1001, scales (2, 1), softmax and sigmoid; no
   biases; T=5, below a halo), |diff| <= 2e-4 + 2e-4 |plain|, with
   max|diff| / max|plain| printed; then the same at the training shapes
   of blocks 4-8 (B=32, T = 1408 .. 22528), one G step's forward.
12. The split of the StyleMelGAN v1 forward at 512 frames (704 padded):
   noise upsample, blocks 0-2 (module path), blocks 3-8 with and without
   the kernels, the output conv, the whole forward with and without.
13. StyleMelGAN v1 decode through ``bin/decode.main``: a random-init,
   full-width checkpoint with ``generator_params`` verbatim from
   egs/ljspeech/voc1/conf/style_melgan.v1.yaml, decoded with
   ``use_pallas_tade: true`` (6 + 5 + 5 = 16 gated blocks: 16 launches
   each of K8a and K8b) and without, with the same noise; the WAVs agree
   to 2e-4.
14. The WaveNet backward kernel (K4) against its plain version (autograd
   through the plain stack): the gradients of one PWG v1 dilation cycle
   (10 layers in two 5-layer calls) at the v1 training shapes (B=6,
   T=25600) under the loss of tests/test_wavenet_stack_train.py:55-59, a
   ragged case (B=2, T=1000, the d=512 halo past both ends) and one
   without biases, |diff| <= 2e-4 + 1e-3 |plain| on dx, dc and every
   weight gradient; two runs compared bit for bit; CUDA-event times of the
   cycle's backward beside its plain version and its bounds (at the
   split-TF32 tensor-core rate K4 multiplies at, and at the float32
   CUDA-core rate), and a torch.profiler split of its kernels.
15. The split of one PWG v1 train step (B=6, T=25600) with the kernels and
   without: G forward, G losses, G backward, G optimizer step, the D
   phase's G re-run and D update, and whole ``TrainStep`` calls (steps/s).
16. PWG v1 training through ``bin/train.main``: the shipped config at full
   width (V1_PWG_CONFIG with TRAIN_OVERRIDES: 4 steps, D from step 4,
   saves at 2 and 4, an eval at 4) on an npy dump of 8 synthetic
   utterances (150-300 frames, features from ``ops/mel.py``), with the
   kernels (K4: 30 launches per G step) and with ``use_pallas_stack_train:
   false``; the logged losses agree to 1e-4 relative at every step; a
   ``--resume`` from the step-2 checkpoint reproduces steps 3-4 to 1e-4;
   the final checkpoint decodes through ``bin/decode.main``.
17. The MelGAN stack backward kernel (K7) against its plain version
   (autograd through the plain stage): MelGAN v1's three fused stages at
   the training shapes (B=8; T=6400, 12800, 25600 at C=128, 64, 32, the
   last with the final conv to 1 and tanh; 3 stacks at d = 1, 3, 9,
   reflect), ragged replicate and zero-padded cases with the final conv to
   4, a case without biases and one with T just above the reflect pad,
   under a random cotangent of scale 1 / sqrt(B T) with weights that keep
   every gradient of order one, the inputs moved off LeakyReLU's kink at
   0, |diff| <=
   2e-4 + 1e-3 |plain| and max|diff| <= 1e-4 max|plain| on dx and every
   weight and bias gradient, with zeroed and shifted gradients as controls
   that must be rejected; two runs bit for bit; CUDA-event times of the
   three stages' backward beside their plain version and bounds (at the
   split-TF32 tensor-core rate K7 multiplies at, and at the float32
   CUDA-core rate), a torch.profiler split of each stage's kernels (the
   final conv's and K6's re-run apart), and each K7 kernel's registers,
   spills and SASS counts (``ops/kernels/sass.py``).
18. The split of one MelGAN v1 train step (B=8, T=25600) with
   ``use_pallas_stacks_train`` and without, as phase 15, and with it in
   bf16 (``mixed_precision``: K6/K7's bf16 modes), and K6's device time
   over the three fused stages of one G forward (torch.profiler).
19. MelGAN v1 training through ``bin/train.main``: melgan.v1.yaml
   (V1_MELGAN_CONFIG) plus ``use_pallas_stacks_train: true`` at full width
   with TRAIN_OVERRIDES on phase 16's dump (K7: 10 launches per G step, 40
   in all) and without the flag; losses agree to 1e-4 relative at every
   step, a resume from step 2 reproduces steps 3-4, and the final
   checkpoint decodes through ``bin/decode.main`` (K6: 10 launches per
   utterance; its weight split 3 launches per G forward, none in the
   backward).

20. The TADE backward kernels (K9a, K9b) against their plain versions
   (autograd through the plain stage or block): StyleMelGAN v1's blocks
   4-8 at the training shapes (B=32; T = 1408 .. 22528, scales 2 then 1,
   d=2, softmax), each stage alone, each block and the chain of the five,
   ragged cases (B=2, T=1002, scales 2 and 1, softmax and sigmoid; no
   biases; T=18, just above the backward's halo of 16 rows), under random
   weights of unit gain and a random cotangent of scale 1 / sqrt(B sT),
   |diff| <= 2e-4 + 1e-3 |plain| and max|diff| <= 1e-4 max|plain| on dx,
   dc and all 12 weight and bias gradients, with zeroed and shifted
   gradients as controls that must be rejected; two runs bit for bit;
   CUDA-event times of K9a and K9b over blocks 4-8 beside their plain
   versions and their bounds (at the split-TF32 tensor-core rate they
   multiply at, and at the float32 CUDA-core rate), and torch.profiler
   splits by kernel of block 8 and of one G step's blocks 4-8.
21. The split of one StyleMelGAN v1 train step (B=32, T=22528) with
   ``use_pallas_tade_train`` and without, as phase 15, and with it in
   bf16 (``mixed_precision``, K8/K9's bf16 modes).
22. StyleMelGAN v1 training through ``bin/train.main``:
   style_melgan.v1.yaml (V1_STYLE_CONFIG) plus ``use_pallas_tade_train:
   true`` at full width and the shipped batch with TRAIN_OVERRIDES, on an
   npy dump of STYLE_TRAIN_UTTS synthetic utterances (100-131 frames; a
   batch of 32 needs 32 of them), with the kernels (K9a and K9b: 5
   launches each per G step, 20 in all) and without; losses agree to 1e-4
   relative at every step, a resume from step 2 reproduces steps 3-4, and
   the final checkpoint decodes through ``bin/decode.main`` (K8a: 7
   launches per utterance, noise padded to 352 frames).

23. The split of one HiFi-GAN v1 train step (hifigan.v1.yaml verbatim,
   B=16, T=8192; no kernel runs in it), as phase 15: G forward, G
   losses (mel, D on y_, D on y for feature matching), G backward, G
   optimizer step, the D phase's G re-run, D's two forwards with its
   backward and step, ``TrainStep`` G-only and G+D steps/s and peak memory;
   then the same in bf16 (``mixed_precision``) in the same call, the
   forwards alone in both, and the G forward's kernels of most device time
   in both (torch.profiler).
24. HiFi-GAN v1 training through ``bin/train.main``: the shipped config
   at full width and batch with HIFIGAN_TRAIN_OVERRIDES (TRAIN_OVERRIDES
   with v1's own start steps: steps 1-4 are G only, D only, G+D, G+D), on
   an npy dump of HIFIGAN_TRAIN_UTTS synthetic utterances (150-300 frames;
   a batch of 16 needs 16 of them); every logged loss finite; a
   ``--resume`` from the step-2 checkpoint reproduces steps 3-4 to 1e-4
   relative and the spectral norm's (u, v) to 1e-6; one G+D ``TrainStep``
   at B=2 agrees with the CPU's to 1e-4 relative on every loss; the final
   checkpoint decodes through ``bin/decode.main`` with ``--use-pallas-tail``
   (K1 once per utterance) and without, the WAVs within 2e-4.

25. The bf16-resident modes of K6 and K7 (mixed precision) against their
   bf16 plain versions at MelGAN v1's three fused stages (B=8; T=6400,
   12800, 25600 at C=128, 64, 32, the last with the final conv to 1; the
   weights of phase 17, a bf16 input moved off LeakyReLU's kink as K6's
   bf16 chain computes it): K6's float32 chain (what K7's re-run keeps)
   against the plain version's, its bf16 output the chain's rounding bit
   for bit; K7's dx and every gradient under a cotangent of scale 1 /
   sqrt(B T), its plain version fed the chain stack by stack; rms|diff|
   <= 1e-3 rms|plain| and max|diff| <= 1e-2 max|plain|, where the float32
   kernels on the same values and weights cut to bf16 by truncation (and
   for K7 each zeroed gradient) must be rejected; CUDA-event times of one
   G step's K6 forward and K7 beside their bf16 plain versions and the
   float32 kernels, and their bf16 bounds (bf16 operations over 989
   TFLOP/s, bf16 bytes over 3.35 TB/s). The same at MB-MelGAN v2's two
   fused stages (B=64; T=2048 at C=96, 4096 at C=48 with the final conv
   to 4; 4 stacks, dilations 1-27), where K6's max|diff| is held to 2e-2
   of max|plain|, and their times per v2 G step. At each stage the plain
   versions with other float32 sums (``_reordered_conv_cl``) are held
   against the plain versions and printed beside, a witness of how far
   two faithful versions part. K6 and K7 run twice at each stage for the
   same bits; their kernels (csrc/melgan_stack_bf16.cu,
   csrc/melgan_stack_bwd_bf16.cu) must multiply as HGMMA ... F32.BF16
   with no HMMA and no spill, and must be among the built kernels; K7 is
   timed on the forward's weight layout, as training runs it, and both
   are split by part (``time_melgan.bf16_parts``: K6's kernels, K7's
   kernels, reduce, weight layout, glue) at v1 and v2.
26. HiFi-GAN v1 with ``mixed_precision`` (the main path in bf16):
   hifigan.v1.fullscale.bf16.yaml (V1_HIFIGAN_BF16_CONFIG) through
   ``bin/train.main`` at full width and batch with
   HIFIGAN_TRAIN_OVERRIDES on a dump of HIFIGAN_TRAIN_UTTS utterances,
   every logged loss finite, a resume from step 2 logging steps 3-4 within
   1e-2 relative, every tensor of the checkpoints (both models, both
   optimizers, spectral norm's (u, v)) float32; one G+D step at B=2 on
   the card against the CPU's within 1e-2 relative (bf16 rounds at other
   elements in cuDNN and on the CPU), and its first-step losses against the
   float32 step's within 3e-2 (tests/test_mixed_precision.py:123's bound)
   and apart by more than 1e-4 in some loss.
   Phase 23 splits the bf16 step beside the float32 one.
27. MelGAN v1 with ``mixed_precision`` and ``use_pallas_stacks_train``
   through ``bin/train.main`` (TRAIN_OVERRIDES, phase 16's dump, a
   checkpoint after every step): K6's bf16 mode 18 launches per G step
   and 10 per bf16 G forward without grad (the D phase's re-run), K7's 10
   per G step; each step again with K6's and K7's bf16 plain versions on
   the card, from the kernel run's checkpoint of the step before, logs the
   same losses within 1e-2 relative, and a model that took no step comes
   out unmoved. Printed beside, not held: the state each step leaves
   (parameters, update, moments, gradient), the kernels' and the plain
   versions' with other float32 sums, each against the plain versions';
   and the kernel run and three plain runs left to themselves (the plain
   versions again, with torch's float32 Hann window, with other sums)
   against a plain run. Neither can be bounded: one spectral bin at the
   STFT loss's clamp, put on either side by two faithful versions, moves
   G's gradient by up to several times its rms (PERF.md §6).
28. The bf16-resident modes of K8a/K8b and K9a/K9b (mixed precision)
   against their bf16 plain versions at StyleMelGAN v1's training blocks
   4-8 (B=32, T = 1408 .. 22528; random unit-gain weights in bf16 from
   SEED, bf16 x and c, bf16 cotangents of scale 1 / sqrt(B sT)): K8a's x2
   and a, K8b's out and a2 (on K8a's outputs), and K9b then K9a stage by
   stage (K9a on K9b's dx2 and da), each plain version of K9 fed the
   kernels' own re-run (``tade*_backward_reference_bf16(..., rerun)``: a
   second bf16 forward would round other elements); rms|diff| <= 1e-3
   rms|plain| and max|diff| <= 1e-2 max|plain| on every output and
   gradient, where the float32 kernels on the same values, the float32
   weights cut to bf16 by truncation and each zeroed output must be
   rejected; two runs of K8a, K8b, K9b and K9a on the same inputs give the
   same bits; registers, spills and SASS of every instantiation of
   ``csrc/tade.cu``, ``csrc/tade_bf16.cu``, ``csrc/tade_bwd.cu`` and
   ``csrc/tade_bwd_bf16.cu`` (K8's bf16 kernels, forward and Save, and
   K9's bf16 chain and weight-gradient kernels must multiply as HGMMA ...
   F32.BF16 warpgroup products, K8's bf16 ones without any HMMA, each
   without TF32 and without a spill); CUDA-event times of one G step's
   K8a, K8b, K9a and K9b (blocks 4-8) beside their bf16 plain versions and
   the float32 kernels, and their bf16 bounds; K8a's and K8b's bf16 time by
   part, forward and Save re-run (``time_tade.k8_parts``: kernel,
   statistics, weight layout, glue), K9a's and K9b's
   (``time_tade.k9_parts``: re-run, chain, weight gradients, reduce, glue)
   and the chain and weight gradients' share of their own bf16 bound.
29. StyleMelGAN v1 with ``mixed_precision`` and ``use_pallas_tade_train``
   through ``bin/train.main`` at full width and the shipped batch of 32 x
   22528 (TRAIN_OVERRIDES, on a dump of STYLE_TRAIN_UTTS utterances):
   K8a/K8b's bf16 modes 5 launches per G step and per D phase re-run and
   5 Save re-runs per G step inside K9a/K9b, K9a/K9b's 5 per G step (the
   eval's forwards run in float32); the same
   run with their bf16 plain versions on the card logs the same losses
   within 1e-2 relative; a resume from step 2 logs steps 3-4 within 1e-2;
   the checkpoints hold float32 alone; one G+D step at B=2 on the card
   (the kernels) against the CPU (the bf16 plain versions) within 1e-2
   relative, and against float32 within 3e-2 and apart by more than 1e-4
   in some loss.
30. K3's bf16-resident mode (``pallas_stack_bf16``) against its bf16 plain
   version at a PWG v1 cycle (B=1, T=131072, 10 layers at d=1..512, C=64,
   aux 80, the generator's weights from SEED with decode's bf16 tiles)
   and a ragged one (B=3, T=777, C=16, aux 10, random weights of gain
   one), through ``csrc/wavenet_bf16.cu`` (one host call a cycle, one
   launch a layer): each layer fed the plain version's input, within rms|diff| <=
   1e-3 rms|plain| and max|diff| <= 1e-2 max|plain| and with at least 99 %
   of the residual bit-equal, where the float32 kernel, the weights cut to
   bf16 by truncation and the plain version with g unrounded must be
   rejected at every layer; the whole cycle within the chain's noise (at
   least 25 % of the residual bit-equal, the skip within 2.5e-3 rms and
   1e-2 max), where the float32 kernel must be rejected; two runs and a
   run that rounds its weights per call bit for bit; one layer (d=512) on
   (64, 557056, 64) with aux 80, past 2**31 elements, its rows 0 and 63
   against the plain version on B = 1 slices by the layer rule; the host
   calls and launches of each; the kernels' registers, spills and SASS
   (HGMMA .F32.BF16, no HMMA, no spill, at most K3_BF16_MAX_REGISTERS
   registers); CUDA-event times of the v1 cycle beside the float32 K3 and
   the bf16 plain version, its bound and the per-layer design's bytes.
31. The rest of the Parallel WaveGAN family on the main path: PWG v1
   decode of the three utterances through ``bin/decode.main
   --use-pallas-stack`` with ``pallas_stack_bf16`` (V1_PWG_GENERATOR
   without ``use_pallas_stack_train``; 90 launches of K3's bf16 mode in 3
   host calls, no float32 K3), held to the same decode with the bf16 plain version
   patched in within 5e-3 rms (its distance from the float32 stack decode
   printed); the causal PWG v1 decode with ``use_pallas_kernels`` (90
   launches of K5's causal call) against its plain decode within 2e-4;
   PWG v1 with ``ResidualParallelWaveGANDiscriminator`` at its defaults
   (30 layers, 64 / 128 / 64) through ``bin/train.main`` at 6 x 25600
   (TRAIN_OVERRIDES with D from step 2, K3/K4 through
   ``use_pallas_stack_train``, and without them; a resume from step 2; the
   checkpoint decoded), and one G+D step at B=2 on the card against the
   CPU within 1e-4 relative.

32. The split of one MB-MelGAN v2 train step (multi_band_melgan.v2.yaml
   verbatim, B=64, T=16384) with ``use_pallas_stacks_train`` and without,
   and with it in bf16 (``mixed_precision``), as phase 15 (G losses: the full band synthesised by PQMF, its STFT
   loss halved, half the sub-band STFT loss, D's adversarial loss), K6's
   device time in one G forward and K6's and K7's, by kernel, in one G
   forward and backward of the auxiliary losses (torch.profiler).
33. MB-MelGAN v2 training through ``bin/train.main``: V2_MB_CONFIG plus
   ``use_pallas_stacks_train: true`` at full width and the shipped batch of
   64 x 16384 with TRAIN_OVERRIDES (D from step 3 for v2's 200000), on an
   npy dump of MB_TRAIN_UTTS synthetic utterances (80-100 frames; a batch
   of 64 needs 64 of them), with the kernels (K6 at C = 96 and 48: 4 + 3
   and 5 + 5 launches per G step, 4 and 5 per G forward without grad; K7
   4 and 5 per G step) and without; losses agree to 1e-4 relative, a
   resume from step 2 reproduces steps 3-4, the checkpoint decodes through
   ``bin/decode.main --use-pallas-stacks`` (K6 then PQMF synthesis, 9
   launches per utterance) within 2e-4 of the plain decode; one G+D step
   at B=2 on the card against the CPU to 1e-4 relative; and the same 4
   steps with ``mixed_precision`` through K6/K7's bf16 modes, held step by
   step as phase 27.
34. The recipe at LJSpeech's shapes, in ``egs/yesno/voc1/run.sh``'s stage
   order, through the port's CLIs: 44 seeded utterances of 1.5-6 s at
   22.05 kHz (harmonics of a random f0 under AM, plus noise; 16-bit WAVs
   written by the port's ``write_wav``), 8 of the train split's 20 cut from
   one recording by a ``segments`` file, 16 dev and 8 eval;
   ``preprocess`` of each split's ``wav.scp`` with hifigan.v1.yaml as it
   ships but npy dumps, ``compute_statistics`` on train, ``normalize``
   (the normalized train features of zero mean and unit scale); HiFi-GAN
   v1 at full width and its batch of 16 x 8192 for 4 steps with
   HIFIGAN_TRAIN_OVERRIDES through ``bin/train.main --train-wav-scp
   --train-feats-scp --train-segments --dev-wav-scp --dev-feats-scp``
   (every loss finite, an eval logged); the eval mels written to a Kaldi
   ark with ``write_ark`` and its feats.scp with byte offsets, decoded by
   ``bin/decode.main --feats-scp --batch-size 4`` with
   ``--use-pallas-tail`` (K1 once per batch: 2 launches) and without, the
   waveforms before the 16-bit rounding within 2e-4 and 1e-4 max|plain|;
   K1 on each batch's own tail input against its plain version with
   CUDA-event times (median of 10) beside its split-TF32 bound; then PWG
   v1 (K3: 30 launches) and MB-MelGAN v2 (K6: 9 launches) decoded by
   ``--feats-scp --batch-size 4`` on UTT_FRAMES and a fourth mel of 512
   frames, each within 2e-4 of its plain batched decode; the host time of
   each stage.
35. The discrete-symbol (HuBERT-unit) vocoders at the widths of their
   shipped configs (embedded copies of hifigan_hubert.v1.yaml,
   hifigan_hubert_duration.v1.yaml and style_melgan_hubert.v1.yaml, held
   equal to the files by a test), random weights from SEED, npy token
   dumps: the discrete HiFi-GAN decodes 3 utterances of 512, 300 and 77
   ids with speaker ids through ``bin/decode.main --use-pallas-tail`` (K1
   once per utterance, its tail entered at 80 frames an id and width 128)
   and without, the waveforms before the 16-bit rounding within 2e-4 and
   1e-4 max|plain|; K1 alone at the 512-id tail, (1, 40960, 128), against
   its plain version with CUDA-event times beside its split-TF32 bound;
   the duration model decodes 200 ids with given durations expanded to
   512 frames through ``InferenceModel.inference(ds=...)`` with K1 (one
   launch) and without, held the same way, and once through its predictor
   by ``bin/decode.main``; the discrete StyleMelGAN decodes the 3
   utterances with ``use_pallas_tade`` (K8a/K8b 18 launches each: blocks
   2-8, 3-8 and 4-8 of the 560, 336 and 112 padded ids) and without, the
   same noise, within 2e-4; it trains 4 steps at 16 x 17920 (D from step
   3) through ``bin/train.main`` with ``use_pallas_tade_train`` (blocks 3-8
   through K8/K9: K8 48 launches, K9 24) and without, the logged losses
   within 1e-4 relative, then the split of its train step by part; the
   duration HiFi-GAN trains 4 steps at 16 x 10240 (no kernel, its own
   start steps), each step's duration loss printed.
36. The VQ-VAE and the U-Net HiFi-GAN at the widths of their shipped
   configs (embedded copies of conditioned_melgan_vae.v3.yaml, opencpop's
   uhifigan.v1.yaml and yesno's uhifigan.v1.debug.yaml, held equal to the
   files by tests), npy dumps made from SEED: the VQ-VAE trains 4 steps at
   16 x 8192 (D from step 3) through ``bin/train.main`` with
   ``decoder_conf.use_pallas_stacks_train`` (its decoder's stages of 128,
   64 and 32 channels through K6/K7: K6 112 launches, K7 40) and without,
   the logged losses within 1e-4 relative; K7 at the decoder's three
   training stages (B=16) against its plain version as phase 17 checks
   it; the trained checkpoint decodes 3 utterances of 96000, 48100 and
   12345 samples with speakers through ``bin/decode.main`` with
   ``decoder_conf.use_pallas_stacks`` (K6 10 launches an utterance) and
   without, the waveforms before the 16-bit rounding within 2e-4 and 1e-4
   max|plain| and the two symbol files ``text`` identical; K6 alone at the
   first utterance's stages ((1, 24064, 128), (1, 48128, 64), (1, 96256,
   32) with the final conv) against its plain version, with CUDA-event
   times beside its split-TF32 bound. The U-Net HiFi-GAN trains 4 G+D
   steps at 16 x 8400 (no kernel) on a dump whose f0 and excitation the
   port's ``ops/f0.py`` made, step 1 at B=2 (dropout 0) holds every loss
   to the CPU's to 1e-5 relative, the checkpoint decodes 3 utterances with
   ``--use-f0-and-excitation`` (its default), and the yesno debug recipe
   trains 2 steps as it ships (AdamW, ExponentialLR).
37. The decode surfaces on full-width random-init checkpoints, each held
   within 2e-4 and 1e-4 max|reference| (waveforms before the 16-bit
   rounding): HiFi-GAN v1 with ``--use-pallas-tail --streaming`` through
   ``bin/decode.main`` on a dump of one 8183-frame (95 s) and one
   200-frame utterance (K1: 3 calls for the long one, its 30 interior
   windows a batch of 32 at (32, 24576, 128); 1 for the short one, which
   falls back to one-shot), against the plain streamed decode and against
   the forward of the exact-length mel; PWG v1 as it ships (K3, 90
   launches) and MB-MelGAN v2 with ``--use-pallas-stacks`` (K6, 27
   launches) streamed on one 2500-frame utterance each, against their
   plain streamed decodes (PWG with the same noise) and the exact-length
   forwards; ``inference_sharded`` over ``make_mesh([cuda:0] * 4)``
   against ``inference`` and ``inference_batch`` over ``[cuda:0] * 2``
   against no mesh (K1); the causal HiFi-GAN v1 (``use_pallas_tail`` set,
   which its gate ignores: no K1 launch) one-shot and streamed on the card
   against the CPU; ``bin/evaluate_mcd.main`` between the streamed and
   one-shot decodes of two utterances of 160 and 192 frames (MCD < 0.01
   dB). Warm (second calls): the 95 s utterance's one-shot and streamed
   wall time and peak device memory, and K1 at (32, 24576, 128) against
   its plain version beside its split-TF32 bound.

Phase 3 also decodes HiFi-GAN v1 with ``use_pallas_mrf: true`` in the
config (K2 called twice per utterance, stages 2 and 3, 8 launches, every
residual unit on the tensor cores) and holds it to the plain decode.
Launch counts are reset just before each decode and read just after it.

The last three lines are the kernel record (JSON), the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}. Every
bound in the record is the larger of the bytes each call must move (each
input read once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM data-sheet peaks at 700 W; for
the kernels that multiply in split TF32 on the tensor cores (K1 to K9),
three TF32 operations per multiply-add's two over 495 TFLOP/s instead,
and for the bf16 modes of K3, K6, K7, K8 and K9 bf16 operations over 989
TFLOP/s and their bf16 bytes.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")
TOL = 2e-4
SEED = 0

# egs/ljspeech/voc1/conf/hifigan.v1.yaml (a test holds these equal to it)
V1_FEATURES = dict(sampling_rate=22050, fft_size=1024, hop_size=256,
                   win_length=None, window="hann", num_mels=80, fmin=80,
                   fmax=7600)
V1_GENERATOR = dict(
    in_channels=80, out_channels=1, channels=512, kernel_size=7,
    upsample_scales=[8, 8, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4],
    resblock_kernel_sizes=[3, 7, 11],
    resblock_dilations=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    use_additional_convs=True, bias=True, nonlinear_activation="LeakyReLU",
    nonlinear_activation_params={"negative_slope": 0.1}, use_weight_norm=True,
)
# egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml (a test holds these equal to it)
V1_PWG_GENERATOR = dict(
    in_channels=1, out_channels=1, kernel_size=3, layers=30, stacks=3,
    residual_channels=64, gate_channels=128, skip_channels=64,
    aux_channels=80, aux_context_window=2, dropout=0.0, use_weight_norm=True,
    upsample_net="ConvInUpsampleNetwork",
    upsample_params={"upsample_scales": [4, 4, 4, 4]},
    use_pallas_stack_train=True,
)
# the rest of egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml (a test holds
# the whole equal to it)
V1_PWG_CONFIG = dict(
    V1_FEATURES, global_gain_scale=1.0, trim_silence=True,
    trim_threshold_in_db=60, trim_frame_size=2048, trim_hop_size=512,
    format="hdf5", generator_params=V1_PWG_GENERATOR,
    discriminator_params=dict(
        in_channels=1, out_channels=1, kernel_size=3, layers=10,
        conv_channels=64, bias=True, use_weight_norm=True,
        nonlinear_activation="LeakyReLU",
        nonlinear_activation_params={"negative_slope": 0.2}),
    stft_loss_params=dict(fft_sizes=[1024, 2048, 512], hop_sizes=[120, 240, 50],
                          win_lengths=[600, 1200, 240], window="hann_window"),
    lambda_adv=4.0, batch_size=6, batch_max_steps=25600, pin_memory=True,
    num_workers=2, remove_short_samples=True, allow_cache=True,
    generator_optimizer_params=dict(lr=1.0e-4, eps=1.0e-6, weight_decay=0.0),
    generator_scheduler_params=dict(step_size=200000, gamma=0.5),
    generator_grad_norm=10,
    discriminator_optimizer_params=dict(lr=5.0e-5, eps=1.0e-6, weight_decay=0.0),
    discriminator_scheduler_params=dict(step_size=200000, gamma=0.5),
    discriminator_grad_norm=1, discriminator_train_start_steps=100000,
    train_max_steps=400000, save_interval_steps=5000, eval_interval_steps=1000,
    log_interval_steps=100, num_save_intermediate_results=4,
    generator_type="ParallelWaveGANGenerator",
    discriminator_type="ParallelWaveGANDiscriminator",
)
# what phase 16 changes in it: npy dumps, 4 steps with D from step 4, a
# save at 2 and 4, an eval at 4, every step logged
TRAIN_OVERRIDES = dict(format="npy", train_max_steps=4,
                       discriminator_train_start_steps=2, save_interval_steps=2,
                       eval_interval_steps=4, log_interval_steps=1)
TRAIN_UTTS = 8
# egs/ljspeech/voc1/conf/melgan.v1.yaml (a test holds the whole equal to
# it); phases 17-19 add use_pallas_stacks_train: true to its generator
V1_MELGAN_CONFIG = dict(
    V1_FEATURES, global_gain_scale=1.0, trim_silence=True,
    trim_threshold_in_db=60, trim_frame_size=2048, trim_hop_size=512,
    format="hdf5", generator_type="MelGANGenerator",
    generator_params=dict(
        in_channels=80, out_channels=1, kernel_size=7, channels=512,
        upsample_scales=[8, 8, 2, 2], stack_kernel_size=3, stacks=3,
        use_weight_norm=True, use_causal_conv=False),
    discriminator_params=V1_PWG_CONFIG["discriminator_params"],
    stft_loss_params=V1_PWG_CONFIG["stft_loss_params"],
    lambda_adv=4.0, batch_size=8, batch_max_steps=25600, pin_memory=True,
    num_workers=2, remove_short_samples=True, allow_cache=True,
    generator_optimizer_params=dict(lr=1.0e-4, eps=1.0e-6, weight_decay=0.0),
    generator_scheduler_params=dict(step_size=200000, gamma=0.5),
    generator_grad_norm=10,
    discriminator_optimizer_params=dict(lr=5.0e-5, eps=1.0e-6, weight_decay=0.0),
    discriminator_scheduler_params=dict(step_size=200000, gamma=0.5),
    discriminator_grad_norm=1, discriminator_train_start_steps=100000,
    train_max_steps=400000, save_interval_steps=5000, eval_interval_steps=1000,
    log_interval_steps=100, num_save_intermediate_results=4,
    discriminator_type="ParallelWaveGANDiscriminator",
)
# egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml (a test holds these equal to it)
V2_MB_GENERATOR = dict(
    in_channels=80, out_channels=4, kernel_size=7, channels=384,
    upsample_scales=[8, 4, 2], stack_kernel_size=3, stacks=4,
    use_weight_norm=True, use_causal_conv=False,
)
# the whole of egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml (a test
# holds it equal to the file); phases 32-33 add use_pallas_stacks_train:
# true to its generator and train it with TRAIN_OVERRIDES
V2_MB_CONFIG = dict(
    V1_FEATURES, global_gain_scale=1.0, trim_silence=True,
    trim_threshold_in_db=60, trim_frame_size=2048, trim_hop_size=512,
    format="hdf5", generator_type="MelGANGenerator", generator_params=V2_MB_GENERATOR,
    discriminator_type="MelGANMultiScaleDiscriminator",
    discriminator_params=dict(
        in_channels=1, out_channels=1, scales=3, downsample_pooling="AvgPool1d",
        downsample_pooling_params=dict(kernel_size=4, stride=2, padding=1,
                                       count_include_pad=False),
        kernel_sizes=[5, 3], channels=16, max_downsample_channels=512,
        downsample_scales=[4, 4, 4], nonlinear_activation="LeakyReLU",
        nonlinear_activation_params={"negative_slope": 0.2}, use_weight_norm=True),
    stft_loss_params=V1_PWG_CONFIG["stft_loss_params"], use_subband_stft_loss=True,
    subband_stft_loss_params=dict(fft_sizes=[384, 683, 171], hop_sizes=[30, 60, 10],
                                  win_lengths=[150, 300, 60], window="hann_window"),
    use_feat_match_loss=False, lambda_adv=2.5, batch_size=64, batch_max_steps=16384,
    pin_memory=True, num_workers=4, remove_short_samples=True, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1.0e-3, eps=1.0e-7, weight_decay=0.0,
                                    amsgrad=True),
    generator_grad_norm=-1, generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(
        gamma=0.5, milestones=[100000, 200000, 300000, 400000, 500000, 600000]),
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=1.0e-3, eps=1.0e-7, weight_decay=0.0,
                                        amsgrad=True),
    discriminator_grad_norm=-1, discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(
        gamma=0.5, milestones=[100000, 200000, 300000, 400000, 500000, 600000]),
    discriminator_train_start_steps=200000, train_max_steps=1000000,
    save_interval_steps=50000, eval_interval_steps=1000, log_interval_steps=1000,
    num_save_intermediate_results=4,
)
# phase 33's dump: the loader drops incomplete batches, so a batch of 64
# needs 64 utterances; 80-100 frames, each longer than a crop of 64
MB_TRAIN_UTTS = 64
MB_TRAIN_FRAMES = (80, 100)
# K6's launches per MB-MelGAN v2 G forward: stage 1 (C=96) 4 stacks, stage
# 2 (C=48) 4 stacks and the final conv; K7's re-run of them: stage 1's
# first 3 stacks, all of stage 2; K7 one per stack and final conv
MB_K6 = {96: 4, 48: 5}
MB_K6_RERUN = {96: 3, 48: 5}
MB_K7 = {96: 4, 48: 5}
# egs/ljspeech/voc1/conf/style_melgan.v1.yaml (a test holds these equal to it)
V1_STYLE_GENERATOR = dict(
    in_channels=128, aux_channels=80, channels=64, out_channels=1,
    kernel_size=9, dilation=2, bias=True, noise_upsample_scales=[11, 2, 2, 2],
    noise_upsample_activation="LeakyReLU",
    noise_upsample_activation_params={"negative_slope": 0.2},
    upsample_scales=[2, 2, 2, 2, 2, 2, 2, 2, 1], upsample_mode="nearest",
    gated_function="softmax", use_weight_norm=True,
)
# the whole of egs/ljspeech/voc1/conf/style_melgan.v1.yaml (a test holds it
# equal to the file); phases 20-22 add use_pallas_tade_train: true
V1_STYLE_CONFIG = dict(
    V1_FEATURES, global_gain_scale=1.0, trim_silence=False,
    trim_threshold_in_db=60, trim_frame_size=1024, trim_hop_size=256,
    format="hdf5", generator_type="StyleMelGANGenerator",
    generator_params=V1_STYLE_GENERATOR,
    discriminator_type="StyleMelGANDiscriminator",
    discriminator_params=dict(
        repeats=4, window_sizes=[512, 1024, 2048, 4096],
        pqmf_params=[[1, None, None, None], [2, 62, 0.267, 9.0],
                     [4, 62, 0.142, 9.0], [8, 62, 0.07949, 9.0]],
        discriminator_params=dict(
            out_channels=1, kernel_sizes=[5, 3], channels=16,
            max_downsample_channels=512, bias=True, downsample_scales=[4, 4, 4, 1],
            nonlinear_activation="LeakyReLU",
            nonlinear_activation_params={"negative_slope": 0.2}),
        use_weight_norm=True),
    stft_loss_params=V1_PWG_CONFIG["stft_loss_params"], lambda_aux=1.0,
    lambda_adv=1.0, generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    batch_size=32, batch_max_steps=22528, pin_memory=True, num_workers=2,
    remove_short_samples=False, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1.0e-4, betas=[0.5, 0.9], weight_decay=0.0),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(
        gamma=0.5, milestones=[100000, 300000, 500000, 700000, 900000]),
    generator_grad_norm=-1, discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=2.0e-4, betas=[0.5, 0.9], weight_decay=0.0),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(
        gamma=0.5, milestones=[200000, 400000, 600000, 800000]),
    discriminator_grad_norm=-1, discriminator_train_start_steps=100000,
    train_max_steps=1500000, save_interval_steps=50000, eval_interval_steps=1000,
    log_interval_steps=100, num_save_intermediate_results=4,
)
# phase 22's dump: the loader drops incomplete batches, so a batch of 32
# needs 32 utterances; 100-131 frames, each longer than a crop of 88
STYLE_TRAIN_UTTS = 32
STYLE_TRAIN_FRAMES = (100, 131)
# the whole of egs/ljspeech/voc1/conf/hifigan.v1.yaml (a test holds it equal
# to the file), trained by phases 23-24 as it ships
V1_HIFIGAN_CONFIG = dict(
    V1_FEATURES, global_gain_scale=1.0, trim_silence=False,
    trim_threshold_in_db=20, trim_frame_size=1024, trim_hop_size=256,
    format="hdf5", generator_type="HiFiGANGenerator", generator_params=V1_GENERATOR,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=dict(
        scales=3, scale_downsample_pooling="AvgPool1d",
        scale_downsample_pooling_params=dict(kernel_size=4, stride=2, padding=2),
        scale_discriminator_params=dict(
            in_channels=1, out_channels=1, kernel_sizes=[15, 41, 5, 3], channels=128,
            max_downsample_channels=1024, max_groups=16, bias=True,
            downsample_scales=[4, 4, 4, 4, 1], nonlinear_activation="LeakyReLU",
            nonlinear_activation_params={"negative_slope": 0.1}),
        follow_official_norm=True, periods=[2, 3, 5, 7, 11],
        period_discriminator_params=dict(
            in_channels=1, out_channels=1, kernel_sizes=[5, 3], channels=32,
            downsample_scales=[3, 3, 3, 3, 1], max_downsample_channels=1024,
            bias=True, nonlinear_activation="LeakyReLU",
            nonlinear_activation_params={"negative_slope": 0.1},
            use_weight_norm=True, use_spectral_norm=False)),
    use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=22050, fft_size=1024, hop_size=256, win_length=None,
                         window="hann", num_mels=80, fmin=0, fmax=11025, log_base=None),
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    use_feat_match_loss=True,
    feat_match_loss_params=dict(average_by_discriminators=False,
                                average_by_layers=False, include_final_outputs=False),
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0, batch_size=16,
    batch_max_steps=8192, pin_memory=True, num_workers=2,
    remove_short_samples=False, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=2.0e-4, betas=[0.5, 0.9], weight_decay=0.0),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5,
                                    milestones=[200000, 400000, 600000, 800000]),
    generator_grad_norm=-1, discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=2.0e-4, betas=[0.5, 0.9], weight_decay=0.0),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5,
                                        milestones=[200000, 400000, 600000, 800000]),
    discriminator_grad_norm=-1, generator_train_start_steps=1,
    discriminator_train_start_steps=0, train_max_steps=2500000,
    save_interval_steps=10000, eval_interval_steps=1000, log_interval_steps=100,
    num_save_intermediate_results=4,
)
# the whole of egs/yesno/voc1/conf/hifigan.v1.fullscale.bf16.yaml (a test
# holds it equal to the file): v1 at 8 kHz with mixed_precision, trained by
# phase 26
V1_HIFIGAN_BF16_CONFIG = dict(
    V1_HIFIGAN_CONFIG, sampling_rate=8000, fmax=4000,
    mel_loss_params=dict(V1_HIFIGAN_CONFIG["mel_loss_params"], fs=8000, fmax=4000),
    train_max_steps=26000, save_interval_steps=26000, eval_interval_steps=5000,
    log_interval_steps=200, mixed_precision=True)
# TRAIN_OVERRIDES but v1's own start steps: steps 1-4 are G only, D only,
# G+D, G+D
HIFIGAN_TRAIN_OVERRIDES = {k: v for k, v in TRAIN_OVERRIDES.items()
                           if k != "discriminator_train_start_steps"}
# phase 24's dump: the loader drops incomplete batches, so a batch of 16
# needs 16 utterances
HIFIGAN_TRAIN_UTTS = 16
# a 512-frame StyleMelGAN decode: noise length ceil(512 / 88) = 6, rounded
# up to 8, so the mel is edge-padded to 8 * 88 = 704 frames
STYLE_FRAMES = 704
UTT_FRAMES = (512, 300, 77)
PEAK_FLOPS = 67e12  # float32 on the CUDA cores
PEAK_TF32 = 495e12  # TF32 on the tensor cores (dense)
PEAK_BF16 = 989e12  # bf16 on the tensor cores (dense)
PEAK_BYTES = 3.35e12


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _reset_launch_counts() -> None:
    """Every kernel wrapper's launch (and call) count to 0, just before a
    main path."""
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import (
        fused_hifigan_mrf,
    )
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        run_mrf,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
    )
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
        fused_gated_resblock,
        fused_wavenet_stack,
    )

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
    )
    from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (
        wavenet_stack_backward,
    )

    for fn in (fused_hifigan_tail, fused_wavenet_stack, fused_gated_resblock,
               wavenet_stack_backward, melgan_stacks_backward):
        fn.launches = 0
    fused_wavenet_stack.bf16_launches = fused_wavenet_stack.bf16_calls = 0
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import (
        fused_tade_blocks,
    )

    from parallelwavegan_tpu_torch.ops.kernels.tade_train import tade_block_backward

    for fn in (fused_melgan_stacks, fused_hifigan_mrf):
        fn.launches = fn.calls = 0
    fused_melgan_stacks.bf16_launches = melgan_stacks_backward.bf16_launches = 0
    fused_melgan_stacks.launches_by_width = {}
    melgan_stacks_backward.launches_by_width = {}
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        kernel_weights,
        kernel_weights_bf16,
    )

    kernel_weights.launches = kernel_weights_bf16.launches = 0
    run_mrf.tensor_core_launches = run_mrf.cuda_core_launches = 0
    fused_tade_blocks.calls = 0
    fused_tade_blocks.launches_k8a = fused_tade_blocks.launches_k8b = 0
    tade_block_backward.launches_k9a = tade_block_backward.launches_k9b = 0
    fused_tade_blocks.bf16_launches_k8a = fused_tade_blocks.bf16_launches_k8b = 0
    fused_tade_blocks.bf16_rerun_launches_k8a = fused_tade_blocks.bf16_rerun_launches_k8b = 0
    tade_block_backward.bf16_launches_k9a = tade_block_backward.bf16_launches_k9b = 0


def _bound(flops: float, nbytes: float) -> dict:
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes}


def _split_tf32_bound(rec: dict) -> float:
    """Set rec's bound to that of the units a split-TF32 kernel uses:
    three TF32 products per multiply at the tensor cores' rate, or its
    bytes. Returns its bound at the float32 CUDA-core rate."""
    fp32_ms = rec["bound_ms"]
    tf32_ms = 3 * rec["flops"] / PEAK_TF32 * 1e3
    bytes_ms = rec["bytes"] / PEAK_BYTES * 1e3
    rec["bound_ms"] = max(tf32_ms, bytes_ms)
    rec["bound_by"] = "operations" if tf32_ms >= bytes_ms else "bytes"
    return fp32_ms


def _tail_work(x, w) -> dict:
    """Operations and bytes of one tail call on x with the bundle w."""
    b, t, c = x.shape

    def mrf(blocks, t, c):  # two K-tap C x C convs per unit and dilation
        return sum(2 * blk["w1"].shape[1] * len(blk["dilations"]) * t * c * c
                   for blk in blocks)

    mac = mrf(w["pre_blocks"], t, c) if w["pre_blocks"] else 0
    for st in w["stages"]:
        mac += t * c * (c // 2) * st["deconv_w"].shape[0]
        t, c = t * st["stride"], c // 2
        mac += mrf(st["blocks"], t, c)
    kf, cin, out = w["final_w"].shape
    mac += t * cin * out * kf
    weights = [w["final_w"], w["final_b"]]
    for blocks in [w["pre_blocks"] or []] + [st["blocks"] for st in w["stages"]]:
        weights += [blk[k] for blk in blocks for k in ("w1", "b1", "w2", "b2")]
    weights += [st[k] for st in w["stages"] for k in ("deconv_w", "deconv_b")]
    nbytes = 4 * (x.numel() + b * t * out + sum(v.numel() for v in weights))
    return _bound(2.0 * b * mac, nbytes)


def _wavenet_work(x, c, w) -> dict:
    """Operations and bytes of the gated layers with stacked weights w."""
    b, t, cr = x.shape
    n, k, _, cg = w["wconv"].shape
    mac_per_row = (k * cr * cg + c.shape[2] * cg + w["wskip"].shape[1] * w["wskip"].shape[2]
                   + w["wres"].shape[1] * w["wres"].shape[2])
    nbytes = 4 * (x.numel() + c.numel() + 2 * x.numel()
                  + sum(v.numel() for v in w.values()))
    return _bound(2.0 * b * t * n * mac_per_row, nbytes)


def _unit_gain_blocks(rs, c: int) -> list:
    """An MRF of v1's structure (K = 3, 7, 11 at dilations 1, 3, 5) at
    width c with random weights of gain about one (N(0, 2 / (K c))) and
    biases of 0.1, split as decode splits them: every unit's branch is as
    large as its input, so that one TF32 product per weight shows. On the
    generator's initial weights a branch is a fraction of its input, and
    the check cannot see it (tests/test_torch_port_hifigan_tf32x3.py's
    emulation: 6.8e-6 against a limit of 8.5e-6 on the v1 tail at T0 =
    300)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import with_fragments

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda")

    return with_fragments([
        {"w1": t(rs.randn(3, k, c, c) * (2.0 / (k * c)) ** 0.5), "b1": t(rs.randn(3, c) * 0.1),
         "w2": t(rs.randn(3, k, c, c) * (2.0 / (k * c)) ** 0.5), "b2": t(rs.randn(3, c) * 0.1),
         "dilations": (1, 3, 5)} for k in (3, 7, 11)])


def _unit_gain_tail(rs) -> dict:
    """The v1 tail's bundle (C0 = 128, two stride-2 stages, the output conv
    to 1) with ``_unit_gain_blocks`` MRFs, transposed convs of gain one and
    an output conv of gain 0.3 (the output's tanh below saturation)."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda")

    stages = [{"deconv_w": t(rs.randn(4, cin, cin // 2) / (2 * cin) ** 0.5),
               "deconv_b": t(rs.randn(cin // 2) * 0.1), "stride": 2, "padding": 1,
               "blocks": _unit_gain_blocks(rs, cin // 2)} for cin in (128, 64)]
    return {"pre_blocks": _unit_gain_blocks(rs, 128), "stages": stages,
            "final_w": t(rs.randn(7, 32, 1) * 0.3 / (7 * 32) ** 0.5),
            "final_b": t(rs.randn(1) * 0.1)}


def _without_split(blocks) -> list:
    """The blocks without the split they carry: a call on them makes it."""
    return [{k: v for k, v in blk.items() if k not in ("f1", "f2")} for blk in blocks]


def _mrf_controls(blocks) -> dict:
    """Two wrong splits of an MRF's blocks that the check must reject: unit
    d reading dilation d + 1's fragments, and fragments whose lo halves are
    zero (one TF32 product per weight)."""
    import torch

    lo = torch.tensor([1, 3], device=blocks[0]["f1"].device)
    return {
        "a neighbouring dilation's split": [
            dict(blk, f1=blk["f1"].roll(-1, 0), f2=blk["f2"].roll(-1, 0)) for blk in blocks],
        "the split's lo halves zeroed": [
            dict(blk, f1=blk["f1"].index_fill(-1, lo, 0.0),
                 f2=blk["f2"].index_fill(-1, lo, 0.0)) for blk in blocks],
    }


def _within(got, want) -> tuple:
    """(max|got - want|, its ratio to max|want|, whether both bounds hold:
    2e-4 and 1e-4 max|want|); fails on a wrong shape or non-finite output."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        _fail(f"shapes {tuple(got.shape)} vs {tuple(want.shape)} or non-finite "
              "kernel output")
    err = float((got - want).abs().max())
    ratio = err / float(want.abs().max())
    return err, ratio, err <= TOL and ratio <= 1e-4


def _resunit_resources(label: str) -> None:
    """The residual-unit kernels' registers, spills and SASS counts."""
    from parallelwavegan_tpu_torch.ops.kernels import build, sass

    usage = sass.resource_usage(os.path.join(build.CSRC, "hifigan_tail.cu"))
    for kernel, use in usage.items():
        if kernel.startswith("resunit"):
            print(f"{label} {kernel}: {use.get('registers')} registers, spill stores "
                  f"{use.get('spill_stores')} B, loads {use.get('spill_loads')} B; "
                  f"SASS {use.get('sass')}")


def phase_kernel(card: str) -> dict:
    """K1 vs its plain version at the v1 tail shapes and one ragged case,
    max|diff| <= 2e-4 and <= 1e-4 max|plain|, with controls that the check
    must reject (a neighbouring dilation's split, the lo halves zeroed),
    two runs bit for bit, both bounds, a profiler split by kernel, the
    residual units' registers and SASS counts, and the v1 forward."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        hifigan_tail_reference,
        run_mrf,
    )
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import by_kernel

    def v1(**flags):
        gen = get_model_class("HiFiGANGenerator")(
            **V1_GENERATOR, **flags, device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        gen.remove_weight_norm()
        gen.eval()
        gen.prepare_kernels()
        return gen

    gen = v1(use_pallas_tail=True)
    kept, per_call = gen._tail_cache, gen.tail_weights()  # with decode's split, without
    rs = np.random.RandomState(SEED)
    unit = _unit_gain_tail(rs)

    def tail(x, w):
        return fused_hifigan_tail(x, w["stages"], w["final_w"], w["final_b"],
                                  slope=gen.slope, pre_blocks=w["pre_blocks"])

    def plain(x, w=per_call):
        return hifigan_tail_reference(x, w["stages"], w["final_w"], w["final_b"],
                                      slope=gen.slope, pre_blocks=w["pre_blocks"])

    def with_blocks(w, fn):  # the bundle with fn applied to every MRF's blocks
        return dict(w, pre_blocks=fn(w["pre_blocks"]) if w["pre_blocks"] else None,
                    stages=[dict(st, blocks=fn(st["blocks"])) for st in w["stages"]])

    bundles = {"decode's weights": (kept, per_call),
               "unit-gain weights": (unit, with_blocks(unit, _without_split))}
    record = {"errs": []}
    with torch.inference_mode():
        for name, (b, t0) in (("v1", (1, 32768)), ("ragged", (2, 1000))):
            x = torch.from_numpy(
                (rs.randn(b, t0, 128) * 0.5).astype(np.float32)).to("cuda")
            for label, (w, w_split) in bundles.items():
                run_mrf.tensor_core_launches = run_mrf.cuda_core_launches = 0
                got = tail(x, w)
                torch.cuda.synchronize()
                routes = (run_mrf.tensor_core_launches, run_mrf.cuda_core_launches)
                ref = plain(x, w_split)
                torch.cuda.synchronize()
                if got.shape != (b, t0 * 4, 1):
                    _fail(f"{name}: shape {tuple(got.shape)}")
                err, ratio, ok = _within(got, ref)
                print(f"K1 vs plain [{name} B={b} T0={t0} C0=128, {label}]: max|diff| = "
                      f"{err:.3e} (tol {TOL}), {ratio:.2e} of max|plain| (tol 1e-4); "
                      f"residual-unit launches on the tensor cores {routes[0]}, on the "
                      f"CUDA cores {routes[1]}")
                if not ok:
                    _fail(f"{name}, {label}: K1 disagrees with its plain version")
                if routes != (9, 0):
                    _fail(f"{name}: residual-unit routes {routes}, expected all 9 "
                          "launches (3 MRFs x 3 dilation depths) on the tensor cores")
                record["errs"].append(err)
                same = torch.equal(got, tail(x, w)) and torch.equal(got, tail(x, w_split))
                print(f"K1 determinism [{name}, {label}]: two runs, and a run that "
                      f"splits its weights, bitwise equal = {same}")
                if not same:
                    _fail(f"K1 gives different outputs in two runs ({name}, {label})")
            ref = plain(x, unit)
            for control in _mrf_controls(unit["pre_blocks"]):
                bad = with_blocks(unit, lambda bl, c=control: _mrf_controls(bl)[c])
                cerr, cratio, cok = _within(tail(x, bad), ref)
                print(f"K1 check control [{name}, unit-gain weights, {control}]: "
                      f"max|diff| = {cerr:.3e}, {cratio:.2e} of max|plain|: rejected = "
                      f"{not cok}")
                if cok:
                    _fail(f"phase 2's check accepts K1 with {control} ({name})")
            if name == "v1":
                record["ms"] = _median_ms(lambda: tail(x, kept))
                record["split_per_call_ms"] = _median_ms(lambda: tail(x, per_call))
                record["plain_ms"] = _median_ms(lambda: plain(x))
                record.update(_tail_work(x, kept))
                fp32_ms = _split_tf32_bound(record)
                print(f"time [K1, v1 tail, median of 10, CUDA events]: kernel "
                      f"{record['ms']:.3f} ms (split kept, as decode), "
                      f"{record['split_per_call_ms']:.3f} ms splitting the weights per "
                      f"call, plain {record['plain_ms']:.3f} ms, bound "
                      f"{record['bound_ms']:.3f} ms at the split-TF32 rate (3 x "
                      f"{record['flops'] / 1e9:.1f} GFLOP / 495 TFLOP/s; "
                      f"{record['bound_ms'] / record['ms']:.1%} of it), {fp32_ms:.3f} ms at "
                      f"the float32 CUDA-core rate ({fp32_ms / record['ms']:.1%}; "
                      f"{record['bytes'] / 1e6:.1f} MB) on {card}")
                from torch.profiler import ProfilerActivity, profile

                tail(x, kept)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    tail(x, kept)
                    torch.cuda.synchronize()
                split = by_kernel(prof)
                total = sum(ms for ms, _ in split.values())
                print(f"K1 one v1 call, device time by kernel (torch.profiler): "
                      f"{total:.3f} ms on {card}: "
                      + "; ".join(f"{k} {ms:.3f} ms ({ms / total:.1%}, {m} launches)"
                                  for k, (ms, m) in split.items()))
        plain_gen = v1()
        mel = torch.from_numpy(rs.randn(1, 80, 512).astype(np.float32)).to("cuda")
        fwd, fwd_plain = _median_ms(lambda: gen(mel)), _median_ms(lambda: plain_gen(mel))
    print(f"HiFi-GAN v1 forward, 512 frames, B=1, median of 10, CUDA events: with the "
          f"tail kernel {fwd:.3f} ms, plain {fwd_plain:.3f} ms on {card}")
    _resunit_resources("K1/K2")
    return record


def _write_inputs(gen_type: str, generator_params: dict, variants: dict,
                  frames=UTT_FRAMES, name: str | None = None) -> dict:
    """Under WORK/<name or gen_type>: a random-init checkpoint, stats, an
    npy dump directory of utterances of ``frames`` frames, and one config
    per variant (overrides of ``generator_params``)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank
    from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint

    root = os.path.join(WORK, name or gen_type)
    shutil.rmtree(root, ignore_errors=True)
    exp, dump = os.path.join(root, "exp"), os.path.join(root, "dump")
    os.makedirs(exp)
    os.makedirs(dump)
    gen = get_model_class(gen_type)(
        **generator_params, generator=torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(exp, "checkpoint-0steps.pkl")
    save_checkpoint(ckpt, gen.state_dict(), steps=0)

    rs = np.random.RandomState(SEED)
    hop, fs = V1_FEATURES["hop_size"], V1_FEATURES["sampling_rate"]
    mels = []
    for i, n_frames in enumerate(frames):
        n = n_frames * hop
        t = np.arange(n) / fs
        f0 = 110.0 + 40.0 * i
        audio = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rs.randn(n)
        feats = {k: v for k, v in V1_FEATURES.items() if k != "sampling_rate"}
        mel = logmelfilterbank(audio, fs, **feats)[:n_frames]
        np.save(os.path.join(dump, f"utt{i}-feats.npy"), mel.astype(np.float32))
        mels.append(mel)
    allm = np.concatenate(mels)
    np.save(os.path.join(exp, "stats.npy"),
            np.stack([allm.mean(0), allm.std(0)]).astype(np.float32))

    paths = {"ckpt": ckpt, "dump": dump, "root": root}
    for variant, overrides in variants.items():
        cfg = dict(V1_FEATURES, format="npy", generator_type=gen_type,
                   generator_params=dict(generator_params, **overrides))
        paths[variant] = os.path.join(exp, f"config_{variant}.json")
        with open(paths[variant], "w") as f:
            json.dump(cfg, f)
    return paths


def _read_wavs(outdir: str) -> dict:
    import numpy as np
    from scipy.io import wavfile

    out = {}
    for name in sorted(os.listdir(outdir)):
        _, data = wavfile.read(os.path.join(outdir, name))
        out[name] = data.astype(np.float32) / 32767.0
    return out


def _compare_wavs(dir_a: str, dir_b: str, frames=UTT_FRAMES) -> float:
    """max |a - b| over the utterances of ``frames`` frames each; fails on
    a wrong set, length, non-finite or silent output."""
    import numpy as np

    wav_a, wav_b = _read_wavs(dir_a), _read_wavs(dir_b)
    expected = {f"utt{i}-feats_gen.wav": f * V1_FEATURES["hop_size"]
                for i, f in enumerate(frames)}
    if set(wav_a) != set(expected) or set(wav_b) != set(expected):
        _fail(f"wav files {sorted(wav_a)} / {sorted(wav_b)}")
    err = 0.0
    for name, n in expected.items():
        a, b = wav_a[name], wav_b[name]
        if a.shape != (n,) or b.shape != (n,):
            _fail(f"{name}: lengths {a.shape} / {b.shape}, expected {n}")
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            _fail(f"{name}: non-finite samples")
        if float(np.abs(a).max()) == 0.0:
            _fail(f"{name}: silent output")
        err = max(err, float(np.abs(a - b).max()))
    return err


def _rtfs(res: dict) -> str:
    return f"{res['rtf']:.6f} {['%.6f' % r for r in res['rtfs']]}"


def phase_decode(card: str) -> dict:
    """HiFi-GAN v1 decode entry point with the tail kernel, with the MRF
    kernel (``use_pallas_mrf`` in the config), then with neither."""
    from parallelwavegan_tpu_torch.bin import decode
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import (
        fused_hifigan_mrf,
    )
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        run_mrf,
    )

    p = _write_inputs("HiFiGANGenerator", V1_GENERATOR,
                      {"tail": {"use_pallas_tail": True},
                       "mrf": {"use_pallas_mrf": True},
                       "plain": {"use_pallas_tail": False}})
    common = ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"],
              "--normalize-before", "--device", "cuda"]
    n = len(UTT_FRAMES)
    # tail: one call per utterance (15 launches: 3 MRFs of 3 resunit
    # launches and a mean, 2 deconvs, the output conv); mrf: stages 2 and 3
    # (C = 64, 32), each 3 resunit launches (one per dilation depth) and a
    # mean; every resunit launch on the tensor cores (C = 128, 64, 32)
    expect = {"tail": (n, 0, 0, 9 * n, 0), "mrf": (0, 2 * n, 8 * n, 6 * n, 0),
              "plain": (0, 0, 0, 0, 0)}
    res, counts = {}, {}
    for name in ("tail", "mrf", "plain"):
        _reset_launch_counts()
        res[name] = decode.main(
            common + ["--outdir", os.path.join(p["root"], f"wav_{name}"),
                      "--config", p[name]]
            + (["--use-pallas-tail"] if name == "tail" else []))
        counts[name] = (fused_hifigan_tail.launches, fused_hifigan_mrf.calls,
                        fused_hifigan_mrf.launches, run_mrf.tensor_core_launches,
                        run_mrf.cuda_core_launches)
        print(f"main path [HiFi-GAN v1, {name}]: tail kernel calls = "
              f"{counts[name][0]}, MRF kernel calls = {counts[name][1]} "
              f"(launches {counts[name][2]}); residual-unit launches on the tensor "
              f"cores {counts[name][3]}, on the CUDA cores {counts[name][4]} for {n} "
              "utterances")
        if counts[name] != expect[name]:
            _fail(f"HiFi-GAN {name} decode: counts {counts[name]}, expected "
                  f"{expect[name]}")
    errs = {}
    for name in ("tail", "mrf"):
        errs[name] = _compare_wavs(os.path.join(p["root"], f"wav_{name}"),
                                   os.path.join(p["root"], "wav_plain"))
        print(f"decode with {name} kernel vs without: max|diff| = "
              f"{errs[name]:.3e} (tol {TOL}, 16-bit WAVs)")
        if not errs[name] <= TOL:
            _fail(f"decode with the {name} kernel disagrees with the plain decode")
    print(f"decode RTF (mean of {n} utterances, first one includes warm-up) on "
          f"{card}: " + ", ".join(f"{k} {_rtfs(v)}" for k, v in res.items()))
    shutil.rmtree(p["root"])
    return {"launches": counts["tail"][0], "err": errs["tail"],
            "mrf_launches": counts["mrf"][2], "mrf_err": errs["mrf"]}


def _pwg_v1(flags: dict):
    """The full-width PWG v1 generator from SEED on the card, weight norm
    folded, eval mode, kernel weights prepared."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class

    gen = get_model_class("ParallelWaveGANGenerator")(
        **dict(V1_PWG_GENERATOR, **flags), device="cuda",
        generator=torch.Generator().manual_seed(SEED))
    gen.remove_weight_norm()
    gen.eval()
    gen.prepare_kernels()
    return gen


def phase_wavenet(card: str) -> dict:
    """The WaveNet layer kernel (K3 stack, K5 block) vs its plain version,
    max|diff| <= 2e-4 and <= 1e-4 max|plain|, with controls that the check
    must reject (a neighbouring layer's split, the columns unpaired), two
    runs bit for bit, the bounds at the split-TF32 and float32 rates, the
    kernels' registers and SASS counts, and a profiler split of one cycle
    whose call splits its weights."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import build, sass, tf32x3
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import by_kernel
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
        WEIGHT_KEYS,
        fused_gated_resblock,
        fused_wavenet_stack,
        gated_resblock_reference,
        wavenet_stack_reference,
    )

    gen = _pwg_v1({})
    n = V1_PWG_GENERATOR["layers"] // V1_PWG_GENERATOR["stacks"]
    all_weights, all_dilations = gen._kernel_cache["stack"]  # with decode's split
    kept = {k: v[:n] for k, v in all_weights.items()}  # the first cycle
    weights = {k: kept[k] for k in WEIGHT_KEYS}
    dilations = all_dilations[:n]
    rs = np.random.RandomState(SEED)

    def inputs(b, t):
        x = torch.from_numpy(rs.randn(b, t, 64).astype(np.float32)).to("cuda")
        c = torch.from_numpy(rs.randn(b, t, 80).astype(np.float32)).to("cuda")
        return x, c

    def err_of(got, want):
        for g, r in zip(got, want):
            if g.shape != r.shape or not torch.isfinite(g).all():
                _fail(f"shapes {tuple(g.shape)} vs {tuple(r.shape)} or non-finite "
                      "kernel output")
        return (max(float((g - r).abs().max()) for g, r in zip(got, want)),
                min(float(r.abs().max()) for r in want))

    def check(name, got, want):
        err, peak = err_of(got, want)
        print(f"kernel vs plain [{name}]: max|diff| (x_out, skip) = {err:.3e} "
              f"(tol {TOL}), {err / peak:.2e} of max|plain| (tol 1e-4)")
        if not (err <= TOL and err <= 1e-4 * peak):
            _fail(f"{name}: kernel disagrees with its plain version")
        return err

    def rejected(name, got, want):
        err, peak = err_of(got, want)
        print(f"K3 check control [{name}]: max|diff| = {err:.3e}, "
              f"{err / peak:.2e} of max|plain|: rejected = "
              f"{not (err <= TOL and err <= 1e-4 * peak)}")
        if err <= TOL and err <= 1e-4 * peak:
            _fail(f"phase 4's check accepts the kernel on {name}")

    stack, block = {"errs": []}, {"errs": []}
    with torch.inference_mode():
        for name, (b, t) in (("v1 cycle", (1, 131072)), ("ragged", (2, 1000))):
            x, c = inputs(b, t)
            got = fused_wavenet_stack(x, c, kept, dilations)
            torch.cuda.synchronize()
            want = wavenet_stack_reference(x, c, weights, dilations)
            stack["errs"].append(check(f"stack {name} B={b} T={t}", got, want))
            again = fused_wavenet_stack(x, c, kept, dilations)
            fresh = fused_wavenet_stack(x, c, weights, dilations)  # split per call
            same = all(torch.equal(g, a) and torch.equal(g, f)
                       for g, a, f in zip(got, again, fresh))
            print(f"K3 determinism [{name}]: two runs, and a run that splits its "
                  f"weights, bitwise equal = {same}")
            if not same:
                _fail(f"K3 gives different outputs in two runs ({name})")
            frag = kept["frag"]
            rejected(f"{name}, layer l reads layer l + 1's split", fused_wavenet_stack(
                x, c, dict(weights, frag=frag.roll(-1, dims=0)), dilations), want)
            unpaired = tf32x3._fragments(tf32x3.wavenet_matrix(weights))
            rejected(f"{name}, the columns unpaired", fused_wavenet_stack(
                x, c, dict(weights, frag=unpaired), dilations), want)
            if name == "v1 cycle":
                stack["ms"] = _median_ms(
                    lambda: fused_wavenet_stack(x, c, kept, dilations))
                stack["split_per_call_ms"] = _median_ms(
                    lambda: fused_wavenet_stack(x, c, weights, dilations))
                stack["plain_ms"] = _median_ms(
                    lambda: wavenet_stack_reference(x, c, weights, dilations))
                stack.update(_wavenet_work(x, c, weights))
                fp32_ms = _split_tf32_bound(stack)
                print(f"time [stack, one v1 cycle of 10 layers, B=1 T=131072, "
                      f"median of 10, CUDA events]: kernel {stack['ms']:.3f} ms "
                      f"(split kept, as decode), {stack['split_per_call_ms']:.3f} ms "
                      f"splitting the weights per call, plain "
                      f"{stack['plain_ms']:.3f} ms, bound {stack['bound_ms']:.3f} ms at "
                      f"the split-TF32 rate (3 x {stack['flops'] / 1e9:.1f} GFLOP / 495 "
                      f"TFLOP/s; {stack['bound_ms'] / stack['ms']:.1%} of it), "
                      f"{fp32_ms:.3f} ms at the float32 CUDA-core rate "
                      f"({stack['bytes'] / 1e6:.1f} MB) on {card}")
                from torch.profiler import ProfilerActivity, profile

                fused_wavenet_stack(x, c, weights, dilations)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fused_wavenet_stack(x, c, weights, dilations)
                    torch.cuda.synchronize()
                split = by_kernel(prof)
                layer_ms = sum(ms for k, (ms, _) in split.items()
                               if k.startswith("wavenet_layer_kernel"))
                total = sum(ms for ms, _ in split.values())
                print(f"K3 one v1 cycle splitting its weights, device time by kernel "
                      f"(torch.profiler): layers {layer_ms:.3f} ms, the weight split "
                      f"{total - layer_ms:.3f} ms on {card}: "
                      + "; ".join(f"{k} {ms:.3f} ms ({m} launches)"
                                  for k, (ms, m) in split.items()))

        # K5 on the main path (use_pallas_kernels decode) runs non-causal
        # layers d=1..512 at T up to 131072; the causal case is extra
        for li, t, causal in ((0, 131072, False), (n - 1, 131072, False),
                              (0, 777, False), (2, 777, True)):
            d = dilations[li]
            args = [weights[k][li] for k in WEIGHT_KEYS]
            frag = kept["frag"][li]
            x, c = inputs(1, t)
            got = fused_gated_resblock(x, c, *args, dilation=d, causal=causal,
                                       fragments=frag)
            torch.cuda.synchronize()
            want = gated_resblock_reference(x, c, *args, dilation=d, causal=causal)
            block["errs"].append(check(f"block d={d} causal={causal} B=1 T={t}",
                                       got, want))
            again = fused_gated_resblock(x, c, *args, dilation=d, causal=causal)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                _fail(f"K5 gives different outputs in two runs (d={d})")
            rejected(f"block d={d}, the next layer's split", fused_gated_resblock(
                x, c, *args, dilation=d, causal=causal,
                fragments=kept["frag"][(li + 1) % n]), want)
            if (t, d) == (131072, 1):
                block["ms"] = _median_ms(lambda: fused_gated_resblock(
                    x, c, *args, dilation=d, fragments=frag))
                block["plain_ms"] = _median_ms(lambda: gated_resblock_reference(
                    x, c, *args, dilation=d, causal=False))
                block.update(_wavenet_work(
                    x, c, {k: weights[k][li:li + 1] for k in WEIGHT_KEYS}))
        fp32_ms = _split_tf32_bound(block)
        print(f"time [block, one v1 layer d=1, B=1 T=131072, median of 10, CUDA "
              f"events]: kernel {block['ms']:.3f} ms, plain "
              f"{block['plain_ms']:.3f} ms, bound {block['bound_ms']:.3f} ms at the "
              f"split-TF32 rate ({block['bound_ms'] / block['ms']:.1%} of it), "
              f"{fp32_ms:.3f} ms at the float32 rate on {card}")
    for kernel, use in sass.resource_usage(os.path.join(build.CSRC, "wavenet.cu")).items():
        print(f"K3/K5 {kernel}: {use.get('registers')} registers, spill stores "
              f"{use.get('spill_stores')} B, loads {use.get('spill_loads')} B; "
              f"SASS {use.get('sass')}")
    return {"stack": stack, "block": block}


def phase_pwg_split(card: str) -> None:
    """Where the PWG v1 forward spends its time at 512 frames, B=1."""
    import torch

    gen = _pwg_v1({})
    plain = _pwg_v1({"use_pallas_stack_train": False})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    frames = 512
    z = torch.randn(1, 1, frames * 256, generator=g, device="cuda")
    c = torch.randn(1, 80, frames + 4, generator=g, device="cuda")

    def plain_stack(x, cu):
        skips = 0.0
        for f in plain.conv_layers:
            x, h = f(x, cu)
            skips = skips + h
        return skips

    def last_convs(skips):
        y = skips * (1.0 / len(gen.conv_layers)) ** 0.5
        for f in gen.last_conv_layers:
            y = f(y)
        return y

    with torch.inference_mode():
        cu = gen.upsample_net(c)
        x = gen.first_conv(z)
        skips = plain_stack(x, cu)
        t = {
            "upsample net + first conv": _median_ms(
                lambda: (gen.upsample_net(c), gen.first_conv(z))),
            "30 layers, kernel": _median_ms(
                lambda: gen._fused_stack(x, cu, gen._kernel_cache["stack"])),
            "30 layers, plain": _median_ms(lambda: plain_stack(x, cu)),
            "skip scale + last convs": _median_ms(lambda: last_convs(skips)),
            "forward, kernel": _median_ms(lambda: gen(z, c)),
            "forward, plain": _median_ms(lambda: plain(z, c)),
        }
    print(f"PWG v1 forward split, 512 frames, B=1, median of 10, CUDA events, "
          f"on {card}: " + "; ".join(f"{k} {v:.3f} ms" for k, v in t.items()))


def phase_pwg_decode(card: str) -> dict:
    """PWG v1 decode entry point through the stack kernel, the block kernel
    and the plain path, with the same noise."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import decode
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
        fused_gated_resblock,
        fused_wavenet_stack,
    )

    off = {"use_pallas_stack_train": False}
    p = _write_inputs("ParallelWaveGANGenerator", V1_PWG_GENERATOR,
                      {"stack": {}, "block": dict(off, use_pallas_kernels=True),
                       "plain": off})
    per_run = V1_PWG_GENERATOR["layers"] * len(UTT_FRAMES)
    expect = {"stack": (per_run, 0), "block": (0, per_run), "plain": (0, 0)}
    res, launches = {}, {}
    for name in ("stack", "block", "plain"):
        _reset_launch_counts()
        np.random.seed(SEED)  # the same noise in every run
        res[name] = decode.main(
            ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"],
             "--normalize-before", "--device", "cuda", "--config", p[name],
             "--outdir", os.path.join(p["root"], f"wav_{name}")])
        launches[name] = (fused_wavenet_stack.launches,
                          fused_gated_resblock.launches)
        print(f"main path [PWG v1, {name}]: stack kernel launches = "
              f"{launches[name][0]}, block kernel launches = "
              f"{launches[name][1]} for {len(UTT_FRAMES)} utterances")
        if launches[name] != expect[name]:
            _fail(f"PWG {name} decode: launches {launches[name]}, "
                  f"expected {expect[name]} (every layer of every utterance)")
    errs = {}
    for name in ("stack", "block"):
        errs[name] = _compare_wavs(os.path.join(p["root"], f"wav_{name}"),
                                   os.path.join(p["root"], "wav_plain"))
        print(f"PWG decode [{name} kernel] vs plain: max|diff| = "
              f"{errs[name]:.3e} (tol {TOL}, 16-bit WAVs)")
        if not errs[name] <= TOL:
            _fail(f"PWG decode through the {name} kernel disagrees with the "
                  "plain decode")
    print(f"PWG decode RTF (mean of {len(UTT_FRAMES)} utterances, first one "
          f"includes warm-up) on {card}: "
          + ", ".join(f"{k} {_rtfs(v)}" for k, v in res.items()))
    shutil.rmtree(p["root"])
    return {"stack_launches": launches["stack"][0],
            "block_launches": launches["block"][1], "errs": errs}


def _mb_v2(flags: dict):
    """The full-width MB-MelGAN v2 generator from SEED on the card, weight
    norm folded, eval mode, kernel weights prepared."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class

    gen = get_model_class("MelGANGenerator")(
        **dict(V2_MB_GENERATOR, **flags), device="cuda",
        generator=torch.Generator().manual_seed(SEED))
    gen.remove_weight_norm()
    gen.eval()
    gen.prepare_kernels()
    return gen


def _stacks_work(x, stacks, final) -> dict:
    """Operations and bytes of one fused_melgan_stacks call."""
    b, t, c = x.shape
    mac = sum(st["wd"].shape[0] * c * c + 2 * c * c for st in stacks)
    out_ch = c
    weights = [st[k] for st in stacks for k in ("wd", "bd", "w1", "b1", "ws", "bs")]
    if final is not None:
        mac += final[0].shape[0] * c * final[0].shape[-1]
        out_ch = final[0].shape[-1]
        weights += list(final)
    nbytes = 4 * (x.numel() + b * t * out_ch + sum(w.numel() for w in weights))
    return _bound(2.0 * b * t * mac, nbytes)


def _mrf_work(x, blocks) -> dict:
    """Operations and bytes of one fused_hifigan_mrf call."""
    b, t, c = x.shape
    mac = sum(2 * blk["w1"].shape[1] * len(blk["dilations"]) * c * c
              for blk in blocks)
    weights = [blk[k] for blk in blocks for k in ("w1", "b1", "w2", "b2")]
    nbytes = 4 * (2 * x.numel() + sum(w.numel() for w in weights))
    return _bound(2.0 * b * t * mac, nbytes)


def _timed(rec: dict, name: str, card: str, fn, plain, work: dict) -> None:
    """Median CUDA-event times of kernel and plain, summed into rec."""
    ms, plain_ms = _median_ms(fn), _median_ms(plain)
    print(f"time [{name}, median of 10, CUDA events]: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {work['bound_ms']:.3f} ms "
          f"({work['flops'] / 1e9:.2f} GFLOP, {work['bytes'] / 1e6:.1f} MB, "
          f"{work['bound_by']}) on {card}")
    for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", work["bound_ms"]),
                 ("flops", work["flops"]), ("bytes", work["bytes"])):
        rec[k] = rec.get(k, 0.0) + v
    ops_ms = rec["flops"] / PEAK_FLOPS * 1e3
    rec["bound_by"] = "operations" if ops_ms >= rec["bytes"] / PEAK_BYTES * 1e3 else "bytes"


def _unit_gain_stacks(rs, c: int, dilations) -> list:
    """Random ResidualStacks of width c and gain about one (Wd N(0, 1 /
    (3 c)), W1 and Ws N(0, 1 / c), biases 0.1): every branch as large as
    its input, so that one TF32 product per weight shows. On the
    generator's N(0, 0.02) init a stack's branches are a small part of its
    output and the check cannot see it."""
    import numpy as np
    import torch

    def t(*shape, scale):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    return [{"wd": t(3, c, c, scale=(3 * c) ** -0.5), "bd": t(c, scale=0.1),
             "w1": t(1, c, c, scale=c ** -0.5), "b1": t(c, scale=0.1),
             "ws": t(1, c, c, scale=c ** -0.5), "bs": t(c, scale=0.1),
             "dilation": d} for d in dilations]


def _k6_resources(card: str) -> None:
    """K6's registers, spills and SASS counts; fails unless the stack
    kernel's products are HMMA.1688.F32.TF32 with no FFMA and no spill
    (its bf16 mode, csrc/melgan_stack_bf16.cu, is phase 25's)."""
    from parallelwavegan_tpu_torch.ops.kernels import build, sass

    usage = sass.resource_usage(os.path.join(build.CSRC, "melgan_stack.cu"))
    for kernel, use in usage.items():
        print(f"K6 {kernel}: {use.get('registers')} registers, spill stores "
              f"{use.get('spill_stores')} B, loads {use.get('spill_loads')} B; "
              f"SASS {use.get('sass')} on {card}")
        if kernel.startswith("stack_tc_kernel"):
            counts = use.get("sass", "")
            ffma = re.search(r"FFMA (\d+)", counts)
            if ("HMMA.1688.F32.TF32" not in counts or ffma is None or ffma.group(1) != "0"
                    or use.get("spill_stores") or use.get("spill_loads")):
                _fail(f"K6 {kernel}: expected HMMA.1688.F32.TF32 products, no FFMA and no "
                      f"spill, got {use}")


def phase_melgan_kernel(card: str) -> dict:
    """K6 vs its plain version at the MB-MelGAN v2 stage shapes (512
    frames), on decode's weights (their split as ``prepare_kernels`` keeps
    it) and on random weights of gain one, with the split's lo halves
    zeroed as a control that the check must reject on the latter; ragged
    replicate / zero-padded cases, a padding too wide for one window
    (its taps staged one at a time) and MelGAN v1's training stages (B=8);
    max|diff| <= 2e-4 and <= 1e-4 max|plain|, two runs (and a run that
    splits its weights) bit for bit; K6's weight-split kernel bit for bit
    against its plain version. ms, plain_ms and the bound are those of one
    decode's K6 work, both v2 stages' calls timed in one window, with the
    split kept."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        _packed_biases,
        fused_melgan_stacks,
        kernel_weights,
        melgan_stacks_reference,
        with_fragments,
    )
    from parallelwavegan_tpu_torch.ops.kernels.tf32x3 import stack_forward_fragments
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import profile_by_kernel

    def check_split(name, stacks):  # the split kernel against its plain version
        frags, biases = kernel_weights(stacks)
        same = all(torch.equal(a, b) for a, b in zip(frags, stack_forward_fragments(stacks)))
        same = same and all(torch.equal(a, b) for a, b in zip(biases, _packed_biases(stacks)))
        print(f"K6 weight split [{name}]: kernel and plain version bitwise equal = {same}")
        if not same:
            _fail(f"K6's weight-split kernel disagrees with its plain version ({name})")

    gen = _mb_v2({"use_pallas_stacks": True})
    rs = np.random.RandomState(SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    def lo_zeroed(stacks):  # one TF32 product per weight
        lo = torch.tensor([1, 3], device="cuda")
        return [dict(st, frag=st["frag"].index_fill(-1, lo, 0.0))
                for st in with_fragments(stacks)]

    v2 = V2_MB_GENERATOR
    dils = [v2["stack_kernel_size"] ** j for j in range(v2["stacks"])]
    gp = V1_MELGAN_CONFIG["generator_params"]
    v1_dils = [gp["stack_kernel_size"] ** j for j in range(gp["stacks"])]
    b1, t1 = V1_MELGAN_CONFIG["batch_size"], V1_MELGAN_CONFIG["batch_max_steps"]
    ragged = _unit_gain_stacks(rs, 64, dils)
    wide = _unit_gain_stacks(rs, 128, (1, 130))
    # (name, x, {weights label: (stacks as run, stacks that split per call)},
    # final, mode); decode's stages with the split kept and unit-gain weights
    cases = []
    for i, (t, c) in ((1, (16384, 96)), (2, (32768, 48))):
        kept, per_call = gen._kernel_cache[i], gen.stage_weights(i)
        unit = _unit_gain_stacks(rs, c, dils)
        cases.append((f"v2 stage {i} B=1 T={t} C={c}" + (" + final" if i == 2 else ""),
                      randn(1, t, c, scale=0.5),
                      {"decode's weights": (kept["stacks"], per_call["stacks"]),
                       "unit-gain weights": (with_fragments(unit), unit)},
                      kept["final"], "reflect"))
    cases += [
        ("ragged replicate B=2 T=1000 C=64", randn(2, 1000, 64),
         {"unit-gain weights": (ragged, ragged)}, None, "edge"),
        ("ragged zeros B=2 T=1000 C=64 + final", randn(2, 1000, 64),
         {"unit-gain weights": (ragged, ragged)},
         (randn(7, 64, 4, scale=0.5 / (7 * 64) ** 0.5), randn(4, scale=0.1)), "constant"),
        ("a padding of 130 rows, one tap at a time, B=2 T=600 C=128", randn(2, 600, 128),
         {"unit-gain weights": (wide, wide)}, None, "reflect"),
    ]
    for i in (1, 2, 3):  # MelGAN v1's training forward
        c, t = 512 >> (i + 1), t1 >> (3 - i)
        st = _unit_gain_stacks(rs, c, v1_dils)
        cases.append((f"v1 training stage {i} B={b1} T={t} C={c}" + (" + final" if i == 3 else ""),
                      randn(b1, t, c), {"unit-gain weights": (st, st)},
                      (randn(7, c, 1, scale=0.3 * (7 * c) ** -0.5), randn(1, scale=0.1))
                      if i == 3 else None, "reflect"))
    rec = {"errs": [], "ms": 0.0, "split_per_call_ms": 0.0, "plain_ms": 0.0,
           "flops": 0.0, "bytes": 0.0}
    train = {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0}
    with torch.inference_mode():
        for name, x, weights, final, mode in cases:
            kw = dict(final=final, slope=gen.slope, pad_mode=mode)
            for label, (stacks, unsplit) in weights.items():
                got = fused_melgan_stacks(x, stacks, **kw)
                torch.cuda.synchronize()
                want = melgan_stacks_reference(x, unsplit, **kw)
                torch.cuda.synchronize()
                err, ratio, ok = _within(got, want)
                print(f"K6 vs plain [{name}, {label}]: max|diff| = {err:.3e} (tol {TOL}), "
                      f"{ratio:.2e} of max|plain| (tol 1e-4)")
                if not ok:
                    _fail(f"{name}, {label}: K6 disagrees with its plain version")
                rec["errs"].append(err)
                same = (torch.equal(got, fused_melgan_stacks(x, stacks, **kw))
                        and torch.equal(got, fused_melgan_stacks(x, unsplit, **kw)))
                print(f"K6 determinism [{name}, {label}]: two runs, and a run that "
                      f"splits its weights, bitwise equal = {same}")
                if not same:
                    _fail(f"K6 gives different outputs in two runs ({name}, {label})")
                if name.startswith("v2") and label == "unit-gain weights":
                    cerr, cratio, cok = _within(
                        fused_melgan_stacks(x, lo_zeroed(unsplit), **kw), want)
                    print(f"K6 check control [{name}, {label}, the split's lo halves "
                          f"zeroed]: max|diff| = {cerr:.3e}, {cratio:.2e} of max|plain|: "
                          f"rejected = {not cok}")
                    if cok:
                        _fail(f"phase 7's check accepts K6 with one TF32 product ({name})")
            stacks, unsplit = next(iter(weights.values()))
            check_split(name, unsplit)
            if name.startswith("v2"):
                work = _stacks_work(x, unsplit, final)
                t = {"ms": _median_ms(lambda: fused_melgan_stacks(x, stacks, **kw)),
                     "split_per_call_ms": _median_ms(
                         lambda: fused_melgan_stacks(x, unsplit, **kw)),
                     "plain_ms": _median_ms(
                         lambda: melgan_stacks_reference(x, unsplit, **kw))}
                print(f"time [K6 {name}, median of 10, CUDA events]: kernel "
                      f"{t['ms']:.3f} ms (split kept, as decode), "
                      f"{t['split_per_call_ms']:.3f} ms splitting per call, plain "
                      f"{t['plain_ms']:.3f} ms ({work['flops'] / 1e9:.2f} GFLOP, "
                      f"{work['bytes'] / 1e6:.1f} MB) on {card}")
                for k in ("ms", "split_per_call_ms", "plain_ms"):
                    rec[k] += t[k]
                rec["flops"] += work["flops"]
                rec["bytes"] += work["bytes"]
            elif name.startswith("v1"):
                train["ms"] += _median_ms(lambda: fused_melgan_stacks(x, stacks, **kw))
                train["plain_ms"] += _median_ms(
                    lambda: melgan_stacks_reference(x, stacks, **kw))
                train["flops"] += _stacks_work(x, stacks, final)["flops"]
        # one decode's K6: both stages' calls in one window, as a decode makes
        # them (the second call's host work overlaps the first's kernels)
        x1, x2 = cases[0][1], cases[1][1]
        stages = [(x1, gen._kernel_cache[1], gen.stage_weights(1)),
                  (x2, gen._kernel_cache[2], gen.stage_weights(2))]

        def decode_k6(kept=True, fn=fused_melgan_stacks):
            for x, w, w_per_call in stages:
                fn(x, (w if kept else w_per_call)["stacks"], final=w["final"],
                   slope=gen.slope, pad_mode="reflect")

        separate = {k: rec[k] for k in ("ms", "split_per_call_ms", "plain_ms")}
        rec["ms"] = _median_ms(decode_k6)
        rec["split_per_call_ms"] = _median_ms(lambda: decode_k6(kept=False))
        rec["plain_ms"] = _median_ms(lambda: decode_k6(fn=melgan_stacks_reference))
        split = profile_by_kernel(decode_k6)
    rec.update(_bound(rec["flops"], rec["bytes"]))
    fp32_ms = _split_tf32_bound(rec)
    print(f"K6 per 512-frame decode (both stages' calls in one window, split kept): "
          f"kernel {rec['ms']:.3f} ms ({rec['split_per_call_ms']:.3f} ms splitting per "
          f"call), plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms at the "
          f"split-TF32 rate (3 x {rec['flops'] / 1e9:.2f} GFLOP / 495 TFLOP/s; "
          f"{rec['bound_ms'] / rec['ms']:.1%} of it), {fp32_ms:.4f} ms at the float32 "
          f"CUDA-core rate ({fp32_ms / rec['ms']:.1%}) on {card}; the stages timed apart "
          f"and summed: kernel {separate['ms']:.3f} ms ({separate['split_per_call_ms']:.3f} "
          f"splitting per call), plain {separate['plain_ms']:.3f} ms")
    total = sum(ms for ms, _ in split.values())
    print(f"K6 one decode, device time by kernel (torch.profiler): {total:.3f} ms on "
          f"{card}: " + "; ".join(f"{k} {ms:.3f} ms ({ms / total:.1%}, {m} launches)"
                                  for k, (ms, m) in split.items())
          if total else f"K6 one decode: torch.profiler recorded no device time on {card}")
    print(f"K6 over MelGAN v1's three training stages (B={b1}, one G forward, splitting "
          f"per call as training does): kernel {train['ms']:.3f} ms, plain "
          f"{train['plain_ms']:.3f} ms, bound {3 * train['flops'] / PEAK_TF32 * 1e3:.3f} ms "
          f"at the split-TF32 rate, {train['flops'] / PEAK_FLOPS * 1e3:.3f} ms at the "
          f"float32 rate ({train['flops'] / 1e9:.1f} GFLOP) on {card}")
    _k6_resources(card)
    return rec


def phase_mrf_kernel(card: str) -> dict:
    """K2 vs its plain version at HiFi-GAN v1's MRF shapes (512 frames)
    and one ragged case, within 2e-4 and 1e-4 max|plain|, bit for bit in
    two runs, with phase 2's controls rejected. ms, plain_ms and the bound
    are those of stages 2 and 3, one decode's K2 work with the default
    gate; stage 1 (K2a) is timed apart."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import (
        fused_hifigan_mrf,
        hifigan_mrf_reference,
    )

    gen = get_model_class("HiFiGANGenerator")(
        **V1_GENERATOR, use_pallas_mrf=True, pallas_mrf_max_channels=128,
        device="cuda", generator=torch.Generator().manual_seed(SEED))
    gen.remove_weight_norm()
    gen.eval()
    gen.prepare_kernels()  # decode's blocks, with their split
    rs = np.random.RandomState(SEED)
    slope = gen.slope
    cases = [("v1 stage 2", (1, 65536), 2), ("v1 stage 3", (1, 131072), 3),
             ("v1 stage 1 (K2a width)", (1, 32768), 1), ("ragged B=2 T=1000", (2, 1000), 2)]
    rec, k2a = {"errs": []}, {}
    with torch.inference_mode():
        for name, (b, t), stage in cases:
            kept, per_call = gen._mrf_cache[stage], gen.mrf_weights(stage)
            c = kept[0]["w1"].shape[-1]
            unit = _unit_gain_blocks(rs, c)
            x = torch.from_numpy((rs.randn(b, t, c) * 0.5).astype(np.float32)).to("cuda")
            for label, (w, w_split) in (("decode's weights", (kept, per_call)),
                                        ("unit-gain weights", (unit, _without_split(unit)))):
                got = fused_hifigan_mrf(x, w, slope=slope)
                torch.cuda.synchronize()
                want = hifigan_mrf_reference(x, w_split, slope=slope)
                torch.cuda.synchronize()
                err, ratio, ok = _within(got, want)
                print(f"K2 vs plain [{name} C={c}, {label}]: max|diff| = {err:.3e} (tol "
                      f"{TOL}), {ratio:.2e} of max|plain| (tol 1e-4)")
                if not ok:
                    _fail(f"K2 {name}, {label}: kernel disagrees with its plain version")
                rec["errs"].append(err)
                same = (torch.equal(got, fused_hifigan_mrf(x, w, slope=slope)) and
                        torch.equal(got, fused_hifigan_mrf(x, w_split, slope=slope)))
                print(f"K2 determinism [{name}, {label}]: two runs, and a run that "
                      f"splits its weights, bitwise equal = {same}")
                if not same:
                    _fail(f"K2 gives different outputs in two runs ({name}, {label})")
            want = hifigan_mrf_reference(x, unit, slope=slope)
            for control, bad in _mrf_controls(unit).items():
                cerr, cratio, cok = _within(fused_hifigan_mrf(x, bad, slope=slope), want)
                print(f"K2 check control [{name}, unit-gain weights, {control}]: "
                      f"max|diff| = {cerr:.3e}, {cratio:.2e} of max|plain|: rejected = "
                      f"{not cok}")
                if cok:
                    _fail(f"phase 8's check accepts K2 with {control} ({name})")
            if not name.startswith("v1"):
                continue
            target = rec if stage in (2, 3) else k2a
            work = _mrf_work(x, per_call)
            times = {"ms": _median_ms(lambda: fused_hifigan_mrf(x, kept, slope=slope)),
                     "split_per_call_ms": _median_ms(
                         lambda: fused_hifigan_mrf(x, per_call, slope=slope)),
                     "plain_ms": _median_ms(
                         lambda: hifigan_mrf_reference(x, per_call, slope=slope)),
                     "flops": work["flops"], "bytes": work["bytes"]}
            print(f"time [K2 {name} B={b} T={t} C={c}, median of 10, CUDA events]: "
                  f"kernel {times['ms']:.3f} ms (split kept), "
                  f"{times['split_per_call_ms']:.3f} ms splitting per call, plain "
                  f"{times['plain_ms']:.3f} ms ({work['flops'] / 1e9:.2f} GFLOP) on {card}")
            for k, v in times.items():
                target[k] = target.get(k, 0.0) + v
    for label, r in (("K2b per 512-frame decode (stages 2 and 3)", rec),
                     ("K2a, stage 1's MRF", k2a)):
        r.update(_bound(r["flops"], r["bytes"]))
        fp32_ms = _split_tf32_bound(r)
        print(f"{label}: kernel {r['ms']:.3f} ms (split kept), "
              f"{r['split_per_call_ms']:.3f} ms splitting per call, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms at the split-TF32 "
              f"rate ({r['bound_ms'] / r['ms']:.1%} of it), {fp32_ms:.3f} ms at the "
              f"float32 rate ({fp32_ms / r['ms']:.1%}) on {card}")
    return rec


def phase_mbmelgan_split(card: str) -> None:
    """Where the MB-MelGAN v2 forward spends its time at 512 frames, B=1."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
    )
    from parallelwavegan_tpu_torch.ops.pqmf import PQMF

    gen = _mb_v2({"use_pallas_stacks": True})
    plain = _mb_v2({})
    m = gen.melgan
    pqmf = PQMF(4, taps=62, cutoff_ratio=0.15, beta=9.0)
    c = torch.randn(1, 80, 512, generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda")

    def head(x):  # input conv and stage 0 (192 channels: cuDNN in both)
        x = m[1](m[0](x))
        a, d, stacks = gen._stages[0]
        x = m[d](m[a](x))
        for j in stacks:
            x = m[j](x)
        return x

    def up(x, i):
        a, d, _ = gen._stages[i]
        return m[d](m[a](x))

    def plain_stacks(x, i):
        for j in gen._stages[i][2]:
            x = m[j](x)
        return x

    def fused(x, i):
        w = gen._kernel_cache[i]
        return fused_melgan_stacks(x.transpose(1, 2).contiguous(), w["stacks"],
                                   final=w["final"], slope=gen.slope,
                                   pad_mode=gen.pad_mode)

    def plain_tail(x):
        for j in range(gen._tail, len(m)):
            x = m[j](x)
        return x

    with torch.inference_mode():
        h0 = head(c)
        u1 = up(h0, 1)
        h1 = plain_stacks(u1, 1)
        u2 = up(h1, 2)
        bands = plain_tail(plain_stacks(u2, 2)).transpose(1, 2)
        t = {
            "input conv + stage 0": _median_ms(lambda: head(c)),
            "stage 1 act + deconv": _median_ms(lambda: up(h0, 1)),
            "stage 1 stacks, kernel": _median_ms(lambda: fused(u1, 1)),
            "stage 1 stacks, plain": _median_ms(lambda: plain_stacks(u1, 1)),
            "stage 2 act + deconv": _median_ms(lambda: up(h1, 2)),
            "stage 2 stacks + final, kernel": _median_ms(lambda: fused(u2, 2)),
            "stage 2 stacks + final, plain": _median_ms(
                lambda: plain_tail(plain_stacks(u2, 2))),
            "PQMF synthesis": _median_ms(lambda: pqmf.synthesis(bands)),
            "forward + PQMF, kernel": _median_ms(
                lambda: pqmf.synthesis(gen(c).transpose(1, 2))),
            "forward + PQMF, plain": _median_ms(
                lambda: pqmf.synthesis(plain(c).transpose(1, 2))),
        }
    print(f"MB-MelGAN v2 forward split, 512 frames, B=1, median of 10, CUDA "
          f"events, on {card}: " + "; ".join(f"{k} {v:.3f} ms" for k, v in t.items()))


def phase_mbmelgan_decode(card: str) -> dict:
    """MB-MelGAN v2 decode entry point with --use-pallas-stacks, then
    without."""
    from parallelwavegan_tpu_torch.bin import decode
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        kernel_weights,
    )

    p = _write_inputs("MelGANGenerator", V2_MB_GENERATOR, {"config": {}})
    n = len(UTT_FRAMES)
    # stages 1 and 2 (96, 48 channels): 4 stack launches each, and the
    # final conv on stage 2; each stage's weights split once, when the
    # model is loaded (prepare_kernels), and never per utterance
    expect = {"stacks": (2 * n, 9 * n, 2), "plain": (0, 0, 0)}
    res, counts = {}, {}
    for name in ("stacks", "plain"):
        _reset_launch_counts()
        res[name] = decode.main(
            ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"],
             "--normalize-before", "--device", "cuda", "--config", p["config"],
             "--outdir", os.path.join(p["root"], f"wav_{name}")]
            + (["--use-pallas-stacks"] if name == "stacks" else []))
        counts[name] = (fused_melgan_stacks.calls, fused_melgan_stacks.launches,
                        kernel_weights.launches)
        print(f"main path [MB-MelGAN v2, {name}]: stack kernel calls = "
              f"{counts[name][0]}, launches = {counts[name][1]}, weight-split "
              f"launches = {counts[name][2]} for {n} utterances")
        if counts[name] != expect[name]:
            _fail(f"MB-MelGAN {name} decode: (calls, launches, split launches) "
                  f"{counts[name]}, expected {expect[name]}")
    err = _compare_wavs(os.path.join(p["root"], "wav_stacks"),
                        os.path.join(p["root"], "wav_plain"))
    print(f"MB-MelGAN decode with stack kernel vs without: max|diff| = {err:.3e} "
          f"(tol {TOL}, 16-bit WAVs)")
    if not err <= TOL:
        _fail("MB-MelGAN decode through the stack kernel disagrees with the "
              "plain decode")
    print(f"MB-MelGAN decode RTF (mean of {n} utterances, first one includes "
          f"warm-up) on {card}: " + ", ".join(f"{k} {_rtfs(v)}" for k, v in res.items()))
    shutil.rmtree(p["root"])
    return {"launches": counts["stacks"][1], "err": err}


def _style_v1(flags: dict):
    """The full-width StyleMelGAN v1 generator from SEED on the card, weight
    norm folded, eval mode, kernel weights prepared."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class

    gen = get_model_class("StyleMelGANGenerator")(
        **dict(V1_STYLE_GENERATOR, **flags), device="cuda",
        generator=torch.Generator().manual_seed(SEED))
    gen.remove_weight_norm()
    gen.eval()
    gen.prepare_kernels()
    return gen


def _tade_work(x, blk, half: int) -> dict:
    """Operations and bytes of one K8a (half 1) or K8b (half 2) call on a
    block input x: ten 9 x 64 x 64 products per row at the kernel's rate."""
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import WEIGHT_KEYS

    b, t, c = x.shape
    rows = b * t * (1 if half == 1 else int(blk["scale"]))
    keys = WEIGHT_KEYS[:3] if half == 1 else WEIGHT_KEYS[3:]
    mac = sum(blk[f"{k}_w"].numel() for k in keys)  # per row
    weights = sum(blk[f"{k}{s}"].numel() for k in keys for s in ("_w", "_b"))
    # K8a reads x, c and writes x2, a; K8b reads x, x2, a and writes out, a2
    acts = 4 * b * t * c if half == 1 else 3 * b * t * c + 2 * rows * c
    return _bound(2.0 * rows * mac, 4 * (acts + 2 * b * c + weights))


def _check_allclose(name: str, got, want) -> float:
    """max |diff|; fails unless |got - want| <= TOL + TOL * |want| throughout."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        _fail(f"{name}: shapes {tuple(got.shape)} vs {tuple(want.shape)} or "
              "non-finite kernel output")
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
    print(f"kernel vs plain [{name}]: max|diff| = {err:.3e}, max|diff| / max|plain| = "
          f"{err / max(float(want.abs().max()), 1e-30):.3e} (rtol {TOL}, atol {TOL})")
    if not ok:
        _fail(f"{name}: kernel disagrees with its plain version")
    return err


def phase_tade_kernel(card: str) -> dict:
    """K8a and K8b vs their plain versions at StyleMelGAN v1's blocks 3-8
    of a 512-frame decode (B=1, T = 5632 .. 180224), on ragged cases and
    at the training shapes of blocks 4-8 (B=32, T = 1408 .. 22528). ms,
    plain_ms and the bound of each kernel are those of the six decode
    blocks, one decode's work ("train": of the five training blocks, one G
    step's forward); the chain of six blocks is timed too."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td

    all_blocks = _style_v1({"use_pallas_tade": True})._kernel_cache
    blocks = all_blocks[3:]
    rs = np.random.RandomState(SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    def random_block(scale, bias=True):
        out = {"scale": scale, "dilation": 2}
        for key in td.WEIGHT_KEYS:
            cout = 64 if key.startswith("aux") else 128
            out[f"{key}_w"] = randn(9, 64, cout, scale=1 / 24.0)
            out[f"{key}_b"] = randn(cout, scale=0.1) if bias else torch.zeros(
                cout, device="cuda")
        return out

    k8a, k8b, chain = {"errs": []}, {"errs": []}, {}
    with torch.inference_mode():
        t = STYLE_FRAMES * 8  # block 3's input length
        x0, c0 = randn(1, t, 64), randn(1, t, 64)
        x, c = x0, c0
        for i, blk in enumerate(blocks, start=3):
            t = x.shape[1]
            x2, a = td.tade1_cuda(x, c, blk)
            torch.cuda.synchronize()
            x2r, ar = (v.contiguous() for v in td.tade1_reference(x, c, blk))
            k8a["errs"] += [_check_allclose(f"K8a block {i} T={t} x2", x2, x2r),
                            _check_allclose(f"K8a block {i} T={t} a", a, ar)]
            out, a2 = td.tade2_cuda(x, x2r, ar, blk)
            torch.cuda.synchronize()
            outr, a2r = (v.contiguous() for v in td.tade2_reference(x, x2r, ar, blk))
            k8b["errs"] += [_check_allclose(f"K8b block {i} T={t} out", out, outr),
                            _check_allclose(f"K8b block {i} T={t} a2", a2, a2r)]
            _timed(k8a, f"K8a block {i} B=1 T={t}", card,
                   lambda: td.tade1_cuda(x, c, blk),
                   lambda: td.tade1_reference(x, c, blk), _tade_work(x, blk, 1))
            _timed(k8b, f"K8b block {i} B=1 T={t} -> {t * int(blk['scale'])}", card,
                   lambda: td.tade2_cuda(x, x2r, ar, blk),
                   lambda: td.tade2_reference(x, x2r, ar, blk), _tade_work(x, blk, 2))
            x, c = outr, a2r

        def plain_chain(x, c):
            for blk in blocks:
                x, c = td.tade_block_reference(x, c, blk)
            return x, c

        got = td.fused_tade_blocks(x0, c0, blocks)
        torch.cuda.synchronize()
        want = plain_chain(x0, c0)
        chain["err"] = max(_check_allclose(f"K8 chain blocks 3-8 {n}", g, w)
                           for n, g, w in zip(("x", "c"), got, want))
        chain["ms"] = _median_ms(lambda: td.fused_tade_blocks(x0, c0, blocks))
        chain["plain_ms"] = _median_ms(lambda: plain_chain(x0, c0))

        # ragged: B=2, odd T, scales (2, 1), both gates, no biases, T below
        # one halo (12 rows)
        for name, (b, t), gated, bias in (
                ("B=2 T=1001 softmax", (2, 1001), "softmax", True),
                ("B=2 T=1001 sigmoid", (2, 1001), "sigmoid", True),
                ("B=1 T=333 no bias", (1, 333), "softmax", False),
                ("B=2 T=5 (below a halo)", (2, 5), "softmax", True)):
            rb = [random_block(2, bias), random_block(1, bias)]
            x, c = randn(b, t, 64), randn(b, t, 64)
            got = td.fused_tade_blocks(x, c, rb, gated_function=gated, min_fused_t=1)
            torch.cuda.synchronize()
            want = (x, c)
            for blk in rb:
                want = td.tade_block_reference(*want, blk, gated_function=gated)
            errs = [_check_allclose(f"K8 ragged {name} {n}", g, w)
                    for n, g, w in zip(("x", "c"), got, want)]
            k8a["errs"].append(max(errs))
            k8b["errs"].append(max(errs))
        del x, c, x0, c0, x2, a, x2r, ar, out, a2, outr, a2r, got, want

        # the training shapes: blocks 4-8 of one G step's forward (B=32)
        train = {"k8a": {"errs": []}, "k8b": {"errs": []}}
        bt = V1_STYLE_CONFIG["batch_size"]
        for i, t, _ in _style_train_blocks():
            blk = all_blocks[i]
            x, c = randn(bt, t, 64), randn(bt, t, 64)
            x2, a = td.tade1_cuda(x, c, blk)
            torch.cuda.synchronize()
            x2r, ar = (v.contiguous() for v in td.tade1_reference(x, c, blk))
            train["k8a"]["errs"] += [
                _check_allclose(f"K8a train block {i} B={bt} T={t} {n}", g, w)
                for n, g, w in (("x2", x2, x2r), ("a", a, ar))]
            out, a2 = td.tade2_cuda(x, x2r, ar, blk)
            torch.cuda.synchronize()
            outr, a2r = (v.contiguous() for v in td.tade2_reference(x, x2r, ar, blk))
            train["k8b"]["errs"] += [
                _check_allclose(f"K8b train block {i} B={bt} T={t} {n}", g, w)
                for n, g, w in (("out", out, outr), ("a2", a2, a2r))]
            del x2, a, out, a2, outr, a2r
            _timed(train["k8a"], f"K8a train block {i} B={bt} T={t}", card,
                   lambda: td.tade1_cuda(x, c, blk),
                   lambda: td.tade1_reference(x, c, blk), _tade_work(x, blk, 1))
            _timed(train["k8b"], f"K8b train block {i} B={bt} T={t} -> "
                   f"{t * int(blk['scale'])}", card,
                   lambda: td.tade2_cuda(x, x2r, ar, blk),
                   lambda: td.tade2_reference(x, x2r, ar, blk), _tade_work(x, blk, 2))
            del x, c, x2r, ar
            torch.cuda.empty_cache()
    # K8 multiplies on the tensor cores in split TF32: each bound is that of
    # the units its products use, the float32 CUDA-core one beside it
    for label, recs in (("per 512-frame decode (blocks 3-8, B=1)", (k8a, k8b)),
                        (f"per StyleMelGAN v1 G-step forward (blocks 4-8, B={bt})",
                         (train["k8a"], train["k8b"]))):
        fp32_ms = [_split_tf32_bound(r) for r in recs]
        print(f"K8 {label}: " + ", ".join(
            f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}; bound {r['bound_ms']:.3f} "
            f"ms at the split-TF32 rate, 3 x {r['flops'] / 1e9:.1f} GFLOP / 495 TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.1%} of it; {f:.3f} ms at the float32 CUDA-core "
            f"rate, {f / r['ms']:.1%} of it)" for k, r, f in zip(("K8a", "K8b"), recs,
                                                                  fp32_ms))
            + f" on {card}")
    print(f"K8 chain of blocks 3-8 (fused_tade_blocks, B=1): {chain['ms']:.3f} ms (plain "
          f"{chain['plain_ms']:.3f}) on {card}")
    return {"k8a": k8a, "k8b": k8b, "chain": chain, "train": train}


def phase_style_split(card: str) -> None:
    """Where the StyleMelGAN v1 forward spends its time at 512 frames (704
    padded), B=1."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import (
        fused_tade_blocks,
    )

    gen = _style_v1({"use_pallas_tade": True})
    plain = _style_v1({})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    nuf = gen.noise_upsample_factor
    z = torch.randn(1, 128, STYLE_FRAMES // nuf, generator=g, device="cuda")
    c = torch.randn(1, 80, STYLE_FRAMES, generator=g, device="cuda")
    w = gen._kernel_cache[3:]

    def head(x, c):  # blocks 0-2, below the gate: module path (cuDNN)
        for blk in gen.blocks[:3]:
            x, c = blk(x, c)
        return x, c

    def fused(x, c):
        y, cy = fused_tade_blocks(x.transpose(1, 2).contiguous(),
                                  c.transpose(1, 2).contiguous(), w)
        return y.transpose(1, 2), cy.transpose(1, 2)

    def plain_tail(x, c):
        for blk in gen.blocks[3:]:
            x, c = blk(x, c)
        return x, c

    with torch.inference_mode():
        x = gen.noise_upsample(z)
        x3, c3 = head(x, c)
        y = plain_tail(x3, c3)[0]
        t = {
            "noise upsample": _median_ms(lambda: gen.noise_upsample(z)),
            "blocks 0-2 (module path)": _median_ms(lambda: head(x, c)),
            "blocks 3-8, kernels": _median_ms(lambda: fused(x3, c3)),
            "blocks 3-8, plain": _median_ms(lambda: plain_tail(x3, c3)),
            "output conv + tanh": _median_ms(lambda: gen.output_conv(y)),
            "forward, kernels": _median_ms(lambda: gen(c, z)),
            "forward, plain": _median_ms(lambda: plain(c, z)),
        }
    print(f"StyleMelGAN v1 forward split, 512 frames ({STYLE_FRAMES} padded), B=1, "
          f"median of 10, CUDA events, on {card}: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in t.items()))


def phase_style_decode(card: str) -> dict:
    """StyleMelGAN v1 decode entry point with use_pallas_tade, then without,
    with the same noise."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import decode
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import (
        fused_tade_blocks,
    )

    p = _write_inputs("StyleMelGANGenerator", V1_STYLE_GENERATOR,
                      {"tade": {"use_pallas_tade": True}, "plain": {}})
    n = len(UTT_FRAMES)
    # 512 frames: blocks 3-8 reach T >= 4096; 300 and 77 frames: blocks 4-8
    expect = {"tade": (n, 16, 16), "plain": (0, 0, 0)}
    res, counts = {}, {}
    for name in ("tade", "plain"):
        _reset_launch_counts()
        np.random.seed(SEED)  # the same noise in every run
        res[name] = decode.main(
            ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"],
             "--normalize-before", "--device", "cuda", "--config", p[name],
             "--outdir", os.path.join(p["root"], f"wav_{name}")])
        counts[name] = (fused_tade_blocks.calls, fused_tade_blocks.launches_k8a,
                        fused_tade_blocks.launches_k8b)
        print(f"main path [StyleMelGAN v1, {name}]: fused_tade_blocks calls = "
              f"{counts[name][0]}, K8a launches = {counts[name][1]}, K8b launches "
              f"= {counts[name][2]} for {n} utterances")
        if counts[name] != expect[name]:
            _fail(f"StyleMelGAN {name} decode: (calls, K8a, K8b) {counts[name]}, "
                  f"expected {expect[name]}")
    err = _compare_wavs(os.path.join(p["root"], "wav_tade"),
                        os.path.join(p["root"], "wav_plain"))
    print(f"StyleMelGAN decode with the TADE kernels vs without: max|diff| = "
          f"{err:.3e} (tol {TOL}, 16-bit WAVs)")
    if not err <= TOL:
        _fail("StyleMelGAN decode through the TADE kernels disagrees with the "
              "plain decode")
    print(f"StyleMelGAN decode RTF (mean of {n} utterances, first one includes "
          f"warm-up) on {card}: " + ", ".join(f"{k} {_rtfs(v)}" for k, v in res.items()))
    shutil.rmtree(p["root"])
    return {"k8a_launches": counts["tade"][1], "k8b_launches": counts["tade"][2],
            "err": err}


def _k4_work(x, c, w) -> dict:
    """Operations and bytes that ``wavenet_stack_backward`` on one chunk of
    L layers needs: each layer's z once, the residual product of the
    first L - 1 layers (the inputs of the later ones), and the backward
    products of all L (dg, the transposed conv, dc and the weight
    gradients). Work the kernel does beyond that (z computed again in the
    backward, the re-run's skip product) is not counted."""
    b, t, cr = x.shape
    n, k, _, cg = w["wconv"].shape
    ca, h = c.shape[2], cg // 2
    z = k * cr * cg + ca * cg
    # dg (res and skip), transposed conv, dc, dwconv + dwaux, dwskip + dwres
    bwd = 2 * h * cr + k * cg * cr + cg * ca + z + 2 * h * cr
    weights = sum(v.numel() for v in w.values())
    # in: x, c, dxo, dsk, weights; out: dx, dc, the weight gradients
    nbytes = 4 * (2 * (x.numel() + c.numel()) + 2 * x.numel() + 2 * weights)
    return _bound(2.0 * b * t * (n * (z + bwd) + (n - 1) * h * cr), nbytes)


def phase_k4(card: str) -> dict:
    """K4 against its plain version: the gradients of one v1 dilation cycle
    (10 layers in two 5-layer calls) at the v1 training shapes (B=6,
    T=25600), a ragged case (B=2, T=1000, the d=512 halo past both ends)
    and one without biases, under the loss of
    tests/test_wavenet_stack_train.py:55-59 scaled so that every gradient
    is well above the tolerance's absolute term, with controls that the
    check must reject; then two runs of the backward
    compared bit for bit, and the backward of the cycle's two chunks timed
    beside its plain version."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
        WEIGHT_KEYS,
        wavenet_stack_reference,
        with_fragments,
    )
    from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (
        fused_wavenet_cycle_train,
        wavenet_stack_backward,
        wavenet_stack_backward_reference,
    )

    n = V1_PWG_GENERATOR["layers"] // V1_PWG_GENERATOR["stacks"]
    with torch.no_grad():
        all_weights, all_dilations = _pwg_v1({}).stack_weights()
    weights = {k: v[:n].contiguous() for k, v in all_weights.items()}
    dils = all_dilations[:n]
    no_bias = {k: torch.zeros_like(v) if k.startswith("b") else v
               for k, v in weights.items()}
    rs = np.random.RandomState(SEED)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to("cuda")

    def grads(x, c, w, kernel: bool):
        xv, cv = x.clone().requires_grad_(), c.clone().requires_grad_()
        wv = {k: w[k].clone().requires_grad_() for k in WEIGHT_KEYS}
        if kernel:
            xo, sk = fused_wavenet_cycle_train(xv, cv, wv, dils, max_layers_per_call=5)
        else:
            xo, sk = wavenet_stack_reference(xv, cv, wv, dils)
        # the loss of tests/test_wavenet_stack_train.py:55-59 times
        # C sqrt(B T): cotangents of order 1 / sqrt(B T), so dx and dc lie
        # well above the tolerance's 2e-4 and the weight gradients are of
        # order one at every (B, T)
        b, t, ch = x.shape
        loss = ((xo ** 2).mean() + 0.5 * (sk ** 2).mean()) * ch * (b * t) ** 0.5
        g = torch.autograd.grad(loss, [xv, cv, *(wv[k] for k in WEIGHT_KEYS)])
        return dict(zip(("dx", "dc") + WEIGHT_KEYS, g))

    def agrees(g, r) -> bool:
        """The JAX test's |diff| <= 2e-4 + 1e-3 |plain| at every element, and
        max|diff| <= 1e-4 max|plain|, which holds at any scale of the
        gradient."""
        d = (g - r).abs()
        return bool((d <= TOL + 1e-3 * r.abs()).all()) and (
            float(d.max()) <= 1e-4 * float(r.abs().max()))

    rec = {"errs": []}
    for name, (b, t), w in (("v1 cycle B=6 T=25600", (6, 25600), weights),
                            ("ragged B=2 T=1000", (2, 1000), weights),
                            ("no biases B=1 T=3000", (1, 3000), no_bias)):
        x, c = randn(b, t, 64), randn(b, t, 80)
        got = grads(x, c, w, True)
        torch.cuda.synchronize()
        want = grads(x, c, w, False)
        for key in got:
            g, r = got[key], want[key]
            if g.shape != r.shape or not torch.isfinite(g).all():
                _fail(f"K4 {name} {key}: shapes {tuple(g.shape)} vs "
                      f"{tuple(r.shape)} or non-finite gradient")
            err = float((g - r).abs().max())
            rel = err / max(float(r.abs().max()), 1e-30)
            print(f"K4 vs plain [{name}] {key}: max|diff| = {err:.3e}, max|plain| "
                  f"= {float(r.abs().max()):.3e}, max|diff| / max|plain| = {rel:.3e} "
                  f"(|diff| <= {TOL} + 1e-3 |plain| and max|diff| <= 1e-4 max|plain|)")
            if not agrees(g, r):
                _fail(f"K4 {name} {key}: kernel disagrees with its plain version")
            rec["errs"].append(err)
        if b == 6:
            # controls at the v1 shapes: wrong gradients that the check must reject
            dx = want["dx"]
            controls = {f"{key} zeroed": (torch.zeros_like(r), r)
                        for key, r in want.items()}
            controls["dx moved 1 % toward its one-sample shift"] = (
                dx + 0.01 * (dx.roll(1, 1) - dx), dx)
            missed = [k for k, (g, r) in controls.items() if agrees(g, r)]
            print(f"K4 check controls [{name}]: {len(controls) - len(missed)} of "
                  f"{len(controls)} wrong gradients rejected")
            if missed:
                _fail(f"K4's check accepts wrong gradients: {missed}")

    x, c = randn(6, 25600, 64), randn(6, 25600, 80)
    dxo, dsk = randn(6, 25600, 64) * 1e-3, randn(6, 25600, 64) * 1e-3
    # with the weights' split for K3's re-run that a training forward makes
    # and its backward reuses (wavenet_stack_train)
    chunks = [(with_fragments({k: v[s:s + 5] for k, v in weights.items()}), dils[s:s + 5])
              for s in (0, 5)]
    first = wavenet_stack_backward(x, c, *chunks[0], dxo, dsk)
    second = wavenet_stack_backward(x, c, *chunks[0], dxo, dsk)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first[:2], second[:2])) and all(
        torch.equal(first[2][k], second[2][k]) for k in WEIGHT_KEYS)
    print(f"K4 determinism: two runs of a v1 chunk bitwise equal = {same}")
    if not same:
        _fail("K4 gives different gradients in two runs")
    for i, (w, d) in enumerate(chunks):
        _timed(rec, f"K4 chunk {i} (layers {5 * i}-{5 * i + 4}) B=6 T=25600", card,
               lambda: wavenet_stack_backward(x, c, w, d, dxo, dsk),
               lambda: wavenet_stack_backward_reference(x, c, w, d, dxo, dsk),
               _k4_work(x, c, w))
    # K4 multiplies on the tensor cores in split TF32: its bound is that of
    # the units it uses
    fp32_ms = _split_tf32_bound(rec)
    print(f"K4 per v1 cycle backward (two 5-layer calls, B=6 T=25600): kernel "
          f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, bound "
          f"{rec['bound_ms']:.3f} ms at the split-TF32 rate (3 x "
          f"{rec['flops'] / 1e9:.1f} GFLOP / 495 TFLOP/s; {rec['bound_ms'] / rec['ms']:.1%} "
          f"of it), {fp32_ms:.3f} ms at the float32 CUDA-core rate on {card}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wavenet_stack_backward(x, c, *chunks[0], dxo, dsk)
        torch.cuda.synchronize()
    names = ("wavenet_layer_kernel", "dz_kernel", "wgrad_kernel",
             "wgrad_reduce_kernel", "dx_kernel")
    split = {n: [0.0, 0] for n in names + ("other",)}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us > 0:
            part = split[next((n for n in names if n in ev.key), "other")]
            part[0] += us / 1e3
            part[1] += ev.count
    print(f"K4 chunk 0 device time by kernel (torch.profiler, one call; "
          f"wavenet_layer_kernel is K3's re-run of layers 0-3) on {card}: "
          + "; ".join(f"{n} {ms:.3f} ms ({k} launches)" for n, (ms, k) in split.items()))
    return rec


def _k7_work(x, stacks, final) -> dict:
    """Operations and bytes that ``melgan_stacks_backward`` on one stage
    needs: each stack's z once, the 1x1 and skip products of every stack
    but the last (the inputs of the later ones), the final conv's forward,
    and the backward products of all (dh, the transposed conv, the skip's
    transpose and the weight gradients; the final conv's transposed conv
    and weight gradient). Work the kernel does beyond that (z computed
    again in the backward, the re-run's last products) is not counted."""
    b, t, c = x.shape
    mac, out_ch = 0, c
    for i, st in enumerate(stacks):
        k = st["wd"].shape[0]
        mac += k * c * c + (2 * k + 4) * c * c + (2 * c * c if i < len(stacks) - 1 else 0)
    weights = [st[key] for st in stacks for key in ("wd", "bd", "w1", "b1", "ws", "bs")
               if st[key] is not None]
    if final is not None:
        kf, _, out_ch = final[0].shape
        mac += 3 * kf * c * out_ch
        weights += [v for v in final if v is not None]
    n_w = sum(w.numel() for w in weights)
    # in: x, dy, weights; out: dx and the weight gradients
    nbytes = 4 * (2 * x.numel() + b * t * out_ch + 2 * n_w)
    return _bound(2.0 * b * t * mac, nbytes)


def _off_the_kinks(x, stacks, fin, mode: str, slope: float, seed: int):
    """(x with some rows moved, the number of rows moved): the rows where
    the plain forward puts an input of LeakyReLU within 1e-5 of its rms of
    the kink at 0 (every stack's input and z, the final conv's input) get
    0.05 N(0, 1) added, until none is left. At such a point float32
    rounding (about 4e-6 at C = 128, measured against float64) can put the
    kernel and the plain version on the two sides of the kink, where the
    derivative jumps by (1 - slope): a difference of the function, not of
    the kernel, that a B T C = 6.5M stage meets a few times."""
    import torch
    import torch.nn.functional as F

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import _conv, _pad_mode

    g = torch.Generator(device=x.device).manual_seed(seed)
    moved = 0
    for _ in range(50):
        near = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)

        def mark(v):
            near.logical_or_((v.abs() < 1e-5 * v.pow(2).mean().sqrt()).any(1))

        with torch.no_grad():
            c = x.transpose(1, 2)
            for st in stacks:
                mark(c)
                p = (st["wd"].shape[0] - 1) // 2 * st["dilation"]
                z = _conv(F.pad(F.leaky_relu(c, slope), (p, p), mode=_pad_mode(mode)),
                          st["wd"], st["bd"], st["dilation"])
                mark(z)
                c = _conv(F.leaky_relu(z, slope), st["w1"], st["b1"]) + _conv(
                    c, st["ws"], st["bs"])
            if fin is not None:
                mark(c)
        rows = near.nonzero()
        if len(rows) == 0:
            return x, moved
        x = x.clone()
        x[rows[:, 0], rows[:, 1]] += 0.05 * torch.randn(
            len(rows), x.shape[2], generator=g, device=x.device)
        moved += len(rows)
    _fail("phase 17: could not move the input off the kinks of LeakyReLU")


def _grads_agree(g, r) -> bool:
    """The JAX test's |diff| <= 2e-4 + 1e-3 |plain| at every element, and
    max|diff| <= 1e-4 max|plain|, which holds at any scale of the
    gradient."""
    d = (g - r).abs()
    return bool((d <= TOL + 1e-3 * r.abs()).all()) and (
        float(d.max()) <= 1e-4 * float(r.abs().max()))


def phase_k7(card: str) -> dict:
    """K7 against its plain version (autograd through the plain stage, its
    forward included): MelGAN v1's three fused stages at the training
    shapes (B=8: T=6400 at C=128, 12800 at 64, 25600 at 32 with the final
    conv to 1 and tanh; 3 stacks at d = 1, 3, 9, reflect; random weights
    from SEED), ragged replicate and zero-padded cases (B=2,
    T=1000, C=48, final conv to 4), a case without biases and one with T
    just above the reflect pad (C=32, d=9, T=10), under a random cotangent
    of scale 1 / sqrt(B T) with weights that keep activations of order one
    (so every weight gradient is of order one and dx far above 2e-4), the
    inputs moved off the kinks of LeakyReLU (``_off_the_kinks``), with
    controls that the check must reject; then two runs compared bit for
    bit, and the three stages' backward timed beside their plain
    version."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        STACK_KEYS,
        fused_melgan_stacks_train,
        melgan_stacks_backward,
        melgan_stacks_backward_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        melgan_stacks_reference,
    )

    gp = V1_MELGAN_CONFIG["generator_params"]
    gen = get_model_class("MelGANGenerator")(**gp, use_pallas_stacks_train=True)
    if gen.fused_stages != (1, 2, 3):
        _fail(f"MelGAN v1 fused stages {gen.fused_stages}, expected (1, 2, 3)")
    slope = gen.slope
    del gen
    rs = np.random.RandomState(SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    # weights that keep activations of order one through the stacks (the
    # generator's N(0, 0.02) init shrinks them, and with them the gradients,
    # below the tolerance's 2e-4)
    def random_stacks(c, dils, bias=True):
        def b():
            return randn(c, scale=0.1) if bias else None

        return [{"wd": randn(3, c, c, scale=(3 * c) ** -0.5), "bd": b(),
                 "w1": randn(1, c, c, scale=c ** -0.5), "b1": b(),
                 "ws": randn(1, c, c, scale=c ** -0.5), "bs": b(),
                 "dilation": d} for d in dils]

    def final(c, out_ch, bias=True):
        return (randn(7, c, out_ch, scale=(7 * c) ** -0.5),
                randn(out_ch, scale=0.1) if bias else None)

    ragged = random_stacks(48, (1, 3, 9))
    b, t = V1_MELGAN_CONFIG["batch_size"], V1_MELGAN_CONFIG["batch_max_steps"]
    dils = [gp["stack_kernel_size"] ** j for j in range(gp["stacks"])]
    # stage i (C = 512 / 2^(i+1)) is 2^(3-i) times shorter than the audio
    cases = [(f"v1 stage {i} B={b} T={t >> (3 - i)} C={512 >> (i + 1)}"
              + (" + final" if i == 3 else ""),
              randn(b, t >> (3 - i), 512 >> (i + 1)),
              random_stacks(512 >> (i + 1), dils),
              final(32, 1) if i == 3 else None, "reflect") for i in (1, 2, 3)]
    cases += [
        ("ragged replicate B=2 T=1000 C=48 + final", randn(2, 1000, 48), ragged,
         final(48, 4), "edge"),
        ("ragged zeros B=2 T=1000 C=48 + final", randn(2, 1000, 48), ragged,
         final(48, 4), "constant"),
        ("no biases B=1 T=3000 C=64 + final", randn(1, 3000, 64),
         random_stacks(64, dils, bias=False), final(64, 1, bias=False), "reflect"),
        ("T just above the pad B=1 T=10 C=32", randn(1, 10, 32),
         random_stacks(32, dils), None, "reflect"),
    ]

    def grads(x, stacks, fin, mode, u, kernel: bool):
        leaves = [x.clone().requires_grad_()]
        sts = []
        for st in stacks:
            d = {"dilation": st["dilation"]}
            for k in STACK_KEYS:
                d[k] = None if st[k] is None else st[k].clone().requires_grad_()
                leaves.append(d[k])
            sts.append(d)
        fv = None if fin is None else tuple(
            None if v is None else v.clone().requires_grad_() for v in fin)
        leaves += list(fv or ())
        fn = fused_melgan_stacks_train if kernel else melgan_stacks_reference
        y = fn(leaves[0], sts, final=fv, slope=slope, pad_mode=mode)
        loss = (y * u).sum()
        names = ["dx"] + [f"stacks[{i}].{k}" for i in range(len(stacks)) for k in STACK_KEYS]
        names += ["final w", "final b"][:len(fv or ())]
        used = [(n, v) for n, v in zip(names, leaves) if v is not None]
        return dict(zip((n for n, _ in used),
                        torch.autograd.grad(loss, [v for _, v in used])))

    rec = {"errs": []}
    for n, (name, x, stacks, fin, mode) in enumerate(cases):
        x, moved = _off_the_kinks(x, stacks, fin, mode, slope, SEED + n)
        cases[n] = (name, x, stacks, fin, mode)
        print(f"K7 [{name}]: {moved} of {x.shape[0] * x.shape[1]} input rows moved "
              "off the kinks of LeakyReLU")
        # a random cotangent of scale 1 / sqrt(B T) (phase 14's loss scaling):
        # the weight gradients, sums over B T rows, are of order one, and dx
        # lies well above the tolerance's 2e-4
        u = randn(*x.shape[:2], x.shape[2] if fin is None else fin[0].shape[2],
                  scale=(x.shape[0] * x.shape[1]) ** -0.5)
        got = grads(x, stacks, fin, mode, u, True)
        torch.cuda.synchronize()
        want = grads(x, stacks, fin, mode, u, False)
        worst = (0.0, "")
        for key in want:
            g, r = got[key], want[key]
            if g.shape != r.shape or not torch.isfinite(g).all():
                _fail(f"K7 {name} {key}: shapes {tuple(g.shape)} vs "
                      f"{tuple(r.shape)} or non-finite gradient")
            if not _grads_agree(g, r):
                _fail(f"K7 {name} {key}: kernel disagrees with its plain version "
                      f"(max|diff| {float((g - r).abs().max()):.3e}, max|plain| "
                      f"{float(r.abs().max()):.3e})")
            err = float((g - r).abs().max())
            rec["errs"].append(err)
            worst = max(worst, (err / max(float(r.abs().max()), 1e-30), key))
        print(f"K7 vs plain [{name}]: {len(want)} gradients, max|diff| = "
              f"{max(rec['errs'][-len(want):]):.3e}, worst max|diff| / max|plain| = "
              f"{worst[0]:.3e} ({worst[1]}; |diff| <= {TOL} + 1e-3 |plain| and "
              f"max|diff| <= 1e-4 max|plain|); max|plain| of dx "
              f"{float(want['dx'].abs().max()):.3e}, least max|plain| of a "
              f"gradient {min(float(r.abs().max()) for r in want.values()):.3e}")
        if name.startswith("v1 stage 1"):
            # controls at the v1 shapes: wrong gradients that the check must reject
            dx = want["dx"]
            controls = {f"{key} zeroed": (torch.zeros_like(r), r) for key, r in want.items()}
            controls["dx moved 1 % toward its one-sample shift"] = (
                dx + 0.01 * (dx.roll(1, 1) - dx), dx)
            missed = [k for k, (g, r) in controls.items() if _grads_agree(g, r)]
            print(f"K7 check controls [{name}]: {len(controls) - len(missed)} of "
                  f"{len(controls)} wrong gradients rejected")
            if missed:
                _fail(f"K7's check accepts wrong gradients: {missed}")
        del got, want

    _, x, stacks, fin, _ = cases[0]
    dy = randn(*x.shape)
    first = melgan_stacks_backward(x, stacks, fin, slope, "reflect", dy)
    second = melgan_stacks_backward(x, stacks, fin, slope, "reflect", dy)
    torch.cuda.synchronize()
    same = torch.equal(first[0], second[0]) and all(
        torch.equal(a[k], b2[k]) for a, b2 in zip(first[1], second[1]) for k in STACK_KEYS)
    print(f"K7 determinism: two runs of v1 stage 1 bitwise equal = {same}")
    if not same:
        _fail("K7 gives different gradients in two runs")
    del first, second
    for name, x, stacks, fin, mode in cases[:3]:
        dy = randn(*x.shape[:2], 1 if fin is not None else x.shape[2], scale=1e-3)
        _timed(rec, f"K7 {name}", card,
               lambda: melgan_stacks_backward(x, stacks, fin, slope, mode, dy),
               lambda: melgan_stacks_backward_reference(x, stacks, fin, slope,
                                                        mode, dy),
               _k7_work(x, stacks, fin))
    # K7 multiplies its stacks on the tensor cores in split TF32: its bound
    # is that of the units it uses
    fp32_ms = _split_tf32_bound(rec)
    print(f"K7 per MelGAN v1 G step backward (stages 1-3, B={b} T={t}, K6's re-run "
          f"included): kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
          f"bound {rec['bound_ms']:.3f} ms at the split-TF32 rate (3 x "
          f"{rec['flops'] / 1e9:.1f} GFLOP / 495 TFLOP/s; {rec['bound_ms'] / rec['ms']:.1%} "
          f"of it), {fp32_ms:.3f} ms at the float32 CUDA-core rate on {card}")

    from parallelwavegan_tpu_torch.ops.kernels import build, sass
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import profile_by_kernel

    k6_ms = k7_ms = 0.0
    for name, x, stacks, fin, mode in cases[:3]:
        dy = randn(*x.shape[:2], 1 if fin is not None else x.shape[2], scale=1e-3)
        split = profile_by_kernel(
            lambda: melgan_stacks_backward(x, stacks, fin, slope, mode, dy))
        k6_ms += sum(ms for n, (ms, _) in split.items()
                     if n.startswith(("split_kernel", "stack_tc_kernel", "outconv_kernel")))
        k7_ms += sum(ms for ms, _ in split.values())
        print(f"K7 {name} device time by kernel (torch.profiler, one call; "
              f"split_kernel, stack_tc_kernel<C> and outconv_kernel are K6's re-run, "
              f"outconv_bwd_kernel and slab_sum_kernel the final conv's backward) "
              f"on {card}: "
              + "; ".join(f"{n} {ms:.3f} ms ({k} launches)" for n, (ms, k) in split.items()))
    print(f"K7 per G step under torch.profiler: {k7_ms:.3f} ms, of which K6's re-run "
          f"{k6_ms:.3f} ms ({k6_ms / max(k7_ms, 1e-9):.1%}) on {card}")
    for kernel, use in sass.resource_usage(
            os.path.join(build.CSRC, "melgan_stack_bwd.cu")).items():
        print(f"K7 {kernel}: {use.get('registers')} registers, spill stores "
              f"{use.get('spill_stores')} B, loads {use.get('spill_loads')} B; "
              f"SASS {use.get('sass')}")
    return rec


def _pwg_v1_config(kernel: bool, **overrides) -> dict:
    """A fresh copy of the PWG v1 training config, with or without the
    stack kernels, and with ``overrides``."""
    cfg = json.loads(json.dumps(V1_PWG_CONFIG))
    cfg["generator_params"]["use_pallas_stack_train"] = kernel
    cfg.update(overrides)
    return cfg


def _melgan_v1_config(kernel: bool, **overrides) -> dict:
    """A fresh copy of the MelGAN v1 training config, with or without the
    stack kernels (``use_pallas_stacks_train``), and with ``overrides``."""
    cfg = json.loads(json.dumps(V1_MELGAN_CONFIG))
    cfg["generator_params"]["use_pallas_stacks_train"] = kernel
    cfg.update(overrides)
    return cfg


def _train_split(card: str, label: str, config_of, batch: dict,
                 forward_kernels: tuple = (),
                 losses: str = "STFT + D adversarial",
                 variants=(("kernel", True), ("plain", False)),
                 step_kernels: tuple = ()) -> None:
    """Where one train step (G and D phases) of ``config_of(kernel)``
    spends its time on ``batch``, for each (name, kernel) of ``variants``
    (with the kernels and through the plain path): CUDA events between the
    parts of the step (median of 5 after two warm-ups), then whole
    ``TrainStep`` calls on the host clock with a synchronise (G-only and
    G+D steps/s). The G losses (``losses`` names them) are the train
    step's: the auxiliary ones, D on the generated wave and, with feature
    matching, D on the real one without grad. With ``forward_kernels``
    (kernel name prefixes), their device time in one G forward with the
    kernels (torch.profiler). A config with ``mixed_precision`` casts as
    ``TrainStep`` does: each phase's parameters and inputs to bf16, the
    outputs back to float32 (the casts of G's parameters timed in G forward
    and the D phase's re-run, those of D's in G losses and the D phase). A
    multi-band generator's sub-bands are synthesised in G losses (and in
    the D phase's re-run), as the train step does. With ``step_kernels``
    (kernel name prefixes), their device time in one G forward and
    backward of the auxiliary losses with the kernels (torch.profiler)."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train import precision
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import (
        TrainStep,
        adv_losses,
        aux_losses,
        full_band,
        generator_forward,
    )

    b, _, t = batch["y"].shape
    parts = ("G forward", f"G losses ({losses})", "G backward",
             "G optimizer step", "D phase: G re-run, no grad",
             "D phase: D forward, backward, step")

    for name, kernel in variants:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg = config_of(kernel)
        init = torch.Generator().manual_seed(SEED)
        gen = get_model_class(cfg["generator_type"])(
            **cfg["generator_params"], generator=init).to("cuda")
        dis = get_model_class(cfg["discriminator_type"])(
            **cfg["discriminator_params"], generator=init).to("cuda")
        crit = build_criterion(cfg)
        opt_g = build_optimizer_from_config(cfg, "generator", gen.parameters())
        opt_d = build_optimizer_from_config(cfg, "discriminator", dis.parameters())
        g_params, d_params = list(gen.parameters()), list(dis.parameters())

        def grads_of(loss, params):  # an unused parameter gets zeros, as in JAX
            return [torch.zeros_like(p) if gr is None else gr for p, gr in zip(
                params, torch.autograd.grad(loss, params, allow_unused=True))]

        def update(opt, params, grads):
            for p, gr in zip(params, grads):
                p.grad = gr
            opt.step()
            for p in params:
                p.grad = None

        mixed = bool(cfg.get("mixed_precision", False))

        def G():  # the generator's output as the train step computes it
            if not mixed:
                return generator_forward(cfg, gen, batch)
            return precision.to_f32(generator_forward(
                cfg, gen, precision.to_bf16(batch), params=precision.bf16_params(gen)))

        def D(v, params):
            if not mixed:
                return dis(v)
            return precision.to_f32(precision.call(dis, params, precision.to_bf16(v)))

        def staged():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
            ev[0].record()
            y_ = G()
            ev[1].record()
            with torch.no_grad():
                p_d = precision.bf16_params(dis) if mixed else None

            def real_features():
                with torch.no_grad():
                    return D(batch["y"], p_d)

            aux, y_ = aux_losses(crit, y_, batch["y"], {})
            loss = (aux * crit.lambda_aux
                    + crit.lambda_adv * adv_losses(crit, D(y_, p_d), real_features, {}))
            ev[2].record()
            grads = grads_of(loss, g_params)
            ev[3].record()
            update(opt_g, g_params, grads)
            ev[4].record()
            with torch.no_grad():
                y_ = full_band(crit, G())
            ev[5].record()
            p_d = precision.bf16_params(dis) if mixed else None
            real, fake = crit.dis_adv(D(y_, p_d), D(batch["y"], p_d))
            update(opt_d, d_params, grads_of(real + fake, d_params))
            ev[6].record()
            torch.cuda.synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(parts))]

        staged()
        staged()
        runs = [staged() for _ in range(5)]
        split = {p: statistics.median(r[i] for r in runs) for i, p in enumerate(parts)}
        # a variant's config argument: the kernel flag, or (it, mixed_precision)
        kernel_on = kernel[0] if isinstance(kernel, tuple) else kernel
        if kernel_on and forward_kernels:
            from parallelwavegan_tpu_torch.ops.kernels.time_melgan import (
                profile_by_kernel,
            )

            mine = {k: v for k, v in profile_by_kernel(G).items()
                    if k.startswith(forward_kernels)}
            print(f"{label} G forward [{name}], B={b} T={t}, device time of "
                  f"{', '.join(forward_kernels)} (torch.profiler, one forward): "
                  f"{sum(ms for ms, _ in mine.values()):.3f} ms on {card}: "
                  + "; ".join(f"{k} {ms:.3f} ms ({n} launches)"
                              for k, (ms, n) in mine.items()))
        if kernel_on and step_kernels:
            from parallelwavegan_tpu_torch.ops.kernels.time_melgan import (
                profile_by_kernel,
            )

            def g_step():  # G forward and the backward of its auxiliary losses
                grads_of(aux_losses(crit, G(), batch["y"], {})[0], g_params)

            split_k = profile_by_kernel(g_step)
            mine = {k: v for k, v in split_k.items() if k.startswith(step_kernels)}
            total = sum(ms for ms, _ in split_k.values())
            print(f"{label} G forward + backward of the auxiliary losses [{name}], B={b} "
                  f"T={t}, device time by kernel (torch.profiler, one call) on {card}: "
                  f"all kernels {total:.3f} ms, of them "
                  + "; ".join(f"{k} {ms:.3f} ms ({n} launches)"
                              for k, (ms, n) in sorted(mine.items())))
        step = TrainStep(cfg, gen, dis, crit, opt_g, opt_d)
        rate = {}
        for phase, flags in (("G-only", (True, False)), ("G+D", (True, True))):
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(batch, *flags)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            rate[phase] = 1.0 / statistics.median(times[1:])
        print(f"{label} train step split [{name}], B={b} T={t}, median of 5, CUDA "
              f"events, on {card}: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items())
              + f"; sum {sum(split.values()):.3f} ms; TrainStep: G-only "
              f"{rate['G-only']:.3f} steps/s, G+D {rate['G+D']:.3f} steps/s "
              f"(median of 3 after one, host clock); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"({held / 2 ** 30:.2f} GiB held before the step was built)")
        del gen, dis, opt_g, opt_d, step, g_params, d_params


def phase_train_split(card: str) -> None:
    """Where one PWG v1 train step (B=6, T=25600) spends its time, with the
    30 layers through K3/K4 and through the plain path."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, t = V1_PWG_CONFIG["batch_size"], V1_PWG_CONFIG["batch_max_steps"]
    frames = t // V1_PWG_CONFIG["hop_size"] + 2 * V1_PWG_GENERATOR["aux_context_window"]
    batch = {"y": 0.3 * torch.randn(b, 1, t, generator=g, device="cuda"),
             "z": torch.randn(b, 1, t, generator=g, device="cuda"),
             "c": torch.randn(b, 80, frames, generator=g, device="cuda")}
    _train_split(card, "PWG v1", _pwg_v1_config, batch)


def phase_melgan_train_split(card: str) -> None:
    """Where one MelGAN v1 train step (B=8, T=25600) spends its time, with
    stages 1-3 through K6/K7 and through the plain path, and in bf16
    (``mixed_precision``) through K6/K7's bf16 modes, and K6's time in the
    G forward."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, t = V1_MELGAN_CONFIG["batch_size"], V1_MELGAN_CONFIG["batch_max_steps"]
    frames = t // V1_MELGAN_CONFIG["hop_size"]
    batch = {"y": 0.3 * torch.randn(b, 1, t, generator=g, device="cuda"),
             "c": torch.randn(b, 80, frames, generator=g, device="cuda")}
    _train_split(card, "MelGAN v1", lambda v: _melgan_v1_config(v[0], mixed_precision=v[1]),
                 batch, forward_kernels=K6_KERNELS, variants=BF16_SPLIT_VARIANTS)


# K6's and K7's kernels (name prefixes), float32 and bf16, for the splits'
# profiles
K6_KERNELS = ("split_kernel", "stack_tc_kernel", "outconv_kernel", "stack_bf16_kernel",
              "outconv_bf16_kernel")
K7_KERNELS = ("dz_kernel", "dx_kernel", "wgrad_kernel", "wgrad_reduce_kernel",
              "outconv_bwd_kernel", "slab_sum_kernel", "dz_bf16_kernel", "dx_bf16_kernel",
              "wgrad_bf16_kernel", "wgrad_reduce_bf16_kernel", "colsum_kernel",
              "outconv_bwd_bf16_kernel")
# (name, (kernel, mixed_precision)) of phases 18 and 32, as phase 21's
BF16_SPLIT_VARIANTS = (("kernel", (True, False)), ("plain", (False, False)),
                       ("bf16, mixed_precision, kernel", (True, True)))


def _write_train_dump(root: str, utts: int = TRAIN_UTTS, span=(150, 300)) -> str:
    """An npy dump of ``utts`` synthetic utterances (``span`` frames):
    ``*-wave.npy`` and ``*-feats.npy`` from the port's ``ops/mel.py``."""
    import numpy as np

    from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank

    dump = os.path.join(root, "dump")
    os.makedirs(dump)
    rs = np.random.RandomState(SEED)
    hop, fs = V1_FEATURES["hop_size"], V1_FEATURES["sampling_rate"]
    feats = {k: v for k, v in V1_FEATURES.items() if k != "sampling_rate"}
    for i in range(utts):
        frames = span[0] + (span[1] - span[0]) * i // (utts - 1)
        n = frames * hop
        t = np.arange(n) / fs
        audio = (0.3 * np.sin(2 * np.pi * (110.0 + 20.0 * i) * t)
                 + 0.05 * rs.randn(n)).astype(np.float32)
        mel = logmelfilterbank(audio, fs, **feats)[:frames]
        np.save(os.path.join(dump, f"utt{i}-wave.npy"), audio)
        np.save(os.path.join(dump, f"utt{i}-feats.npy"), mel.astype(np.float32))
    return dump


def _losses_agree(name: str, got: dict, want: dict, steps) -> float:
    """max relative difference of every logged training loss at ``steps``;
    fails on a missing step or metric or a difference above 1e-4."""
    worst = 0.0
    for s in steps:
        if s not in got or s not in want or sorted(got[s]) != sorted(want[s]):
            _fail(f"{name}: logged steps or metrics differ at step {s}")
        for key, v in want[s].items():
            rel = abs(got[s][key] - v) / max(abs(v), 1e-30)
            if not rel <= 1e-4:
                _fail(f"{name}: step {s} {key} = {got[s][key]!r} vs {v!r}")
            worst = max(worst, rel)
    return worst


def _train_runs(card: str, label: str, config_of, counters: dict, expect: dict,
                decode_count, decode_expect: int, utts: int = TRAIN_UTTS,
                span=(150, 300), decode_flags=(), compare_plain_decode=False) -> dict:
    """Training through ``bin/train.main`` on the card: ``config_of(kernel,
    **TRAIN_OVERRIDES)`` at full width from SEED on ``utts`` utterances of
    ``span`` frames, with the kernels and again without, then a resume from
    the step-2 checkpoint; the launches in ``counters`` (name -> a function
    that reads the count) must equal ``expect[run]``. The logged losses of
    the kernel and plain runs, and of the resumed and uninterrupted runs,
    agree to 1e-4 relative; the final checkpoint decodes through
    ``bin/decode.main`` (with ``decode_flags``) with ``decode_count()`` at
    ``decode_expect``; with ``compare_plain_decode`` it decodes again with
    the plain run's ``config.yml`` (no launch) and the WAVs agree to TOL."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import decode, train

    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    dump = _write_train_dump(root, utts, span)
    configs = {}
    for name, kernel in (("kernel", True), ("plain", False)):
        configs[name] = os.path.join(root, f"config_{name}.json")
        with open(configs[name], "w") as f:
            json.dump(config_of(kernel, **TRAIN_OVERRIDES), f)

    steps = TRAIN_OVERRIDES["train_max_steps"]
    res, launches = {}, {}
    for name, extra in (("kernel", []), ("plain", []),
                        ("resume", ["--resume", os.path.join(
                            root, "exp_kernel", "checkpoint-2steps.pkl")])):
        _reset_launch_counts()
        t0 = time.perf_counter()
        res[name] = train.main(
            ["--train-dumpdir", dump, "--dev-dumpdir", dump, "--outdir",
             os.path.join(root, f"exp_{name}"), "--device", "cuda", "--verbose", "0",
             "--config", configs["plain" if name == "plain" else "kernel"]] + extra)
        seconds = time.perf_counter() - t0
        launches[name] = tuple(count() for count in counters.values())
        print(f"main path [{label} training, {name}]: {res[name]['steps']} steps in "
              f"{seconds:.1f} s (set-up, eval and saves included) on {card}; "
              + ", ".join(f"{k} launches = {n}" for k, n in zip(counters, launches[name])))
        if res[name]["steps"] != steps or launches[name] != expect[name]:
            _fail(f"{label} training {name}: steps {res[name]['steps']}, launches "
                  f"{launches[name]}, expected {steps} and {expect[name]}")

    logged = {name: {s: {k: v for k, v in m.items() if k.startswith("train/")}
                     for s, m in r["history"] if "train/generator_loss" in m}
              for name, r in res.items()}
    for s, m in logged["kernel"].items():
        print(f"  step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
        if not all(np.isfinite(v) for v in m.values()):
            _fail(f"{label} training: non-finite loss at step {s}")
    if "train/discriminator_loss" not in logged["kernel"].get(steps, {}):
        _fail(f"{label} training: the D phase did not run")
    if not any("eval/generator_loss" in m for _, m in res["kernel"]["history"]):
        _fail(f"{label} training: no evaluation was logged")
    err = _losses_agree("kernel vs plain", logged["kernel"], logged["plain"],
                        range(1, steps + 1))
    print(f"{label} training losses, kernel vs plain: max relative diff = {err:.3e} "
          f"over steps 1-{steps} (tol 1e-4)")
    if sorted(logged["resume"]) != [3, 4]:
        _fail(f"{label} resume logged steps {sorted(logged['resume'])}, expected [3, 4]")
    err_resume = _losses_agree("resume vs uninterrupted", logged["resume"],
                               logged["kernel"], (3, 4))
    print(f"{label} training resumed from step 2 vs uninterrupted: max relative diff "
          f"= {err_resume:.3e} over steps 3-4 (tol 1e-4)")

    _reset_launch_counts()
    wavdir = os.path.join(root, "wav")
    ckpt = os.path.join(root, "exp_kernel", f"checkpoint-{steps}steps.pkl")
    decode.main(["--dumpdir", dump, "--outdir", wavdir, "--device", "cuda",
                 "--checkpoint", ckpt, *decode_flags])
    from scipy.io import wavfile

    decode_err = None
    if compare_plain_decode:
        launches_kernel = decode_count()
        # the plain run's own config.yml: the plain flags and the PQMF the
        # training wrote there, which the kernel decode's config.yml holds too
        decode.main(["--dumpdir", dump, "--outdir", os.path.join(root, "wav_plain"),
                     "--device", "cuda", "--checkpoint", ckpt, "--config",
                     os.path.join(root, "exp_plain", "config.yml")])
        if decode_count() != launches_kernel:
            _fail(f"the plain decode of the {label} checkpoint launched a kernel")
        wav_a, wav_b = _read_wavs(wavdir), _read_wavs(os.path.join(root, "wav_plain"))
        if sorted(wav_a) != sorted(wav_b):
            _fail(f"{label} decodes: {sorted(wav_a)} vs {sorted(wav_b)}")
        decode_err = max(float(np.abs(wav_a[k] - wav_b[k]).max()) for k in wav_a)
        print(f"decode of the {label} step-{steps} checkpoint, kernel vs plain: max|diff| "
              f"= {decode_err:.3e} over {len(wav_a)} utterances (tol {TOL})")
        if not decode_err <= TOL:
            _fail(f"{label} checkpoint: the kernel decode disagrees with the plain one")

    wavs = sorted(os.listdir(wavdir))
    if len(wavs) != utts or decode_count() != decode_expect:
        _fail(f"decode of the trained {label} checkpoint: {wavs}, launches "
              f"{decode_count()}, expected {decode_expect}")
    for name in wavs:
        _, data = wavfile.read(os.path.join(wavdir, name))
        frames = np.load(os.path.join(dump, name.replace("_gen.wav", ".npy"))).shape[0]
        if data.shape != (frames * V1_FEATURES["hop_size"],) or not data.any():
            _fail(f"decode of the trained {label} checkpoint: {name} {data.shape}")
    print(f"decode of the {label} step-{steps} checkpoint through bin/decode: "
          f"{len(wavs)} utterances, {decode_count()} launches")
    shutil.rmtree(root)
    return {"launches": launches["kernel"], "err": err, "decode_err": decode_err}


def _eval_and_d_forwards() -> int:
    """G forwards under no_grad in TRAIN_OVERRIDES' 4 steps: the D phase's
    re-run where D trains (the steps done before the step exceed its start:
    step 4), the eval batch and its dumped predictions."""
    steps = TRAIN_OVERRIDES["train_max_steps"]
    return steps - TRAIN_OVERRIDES["discriminator_train_start_steps"] - 1 + 2


def phase_train(card: str) -> dict:
    """PWG v1 training through ``bin/train.main``: K3 in every G forward
    (30 layers), the re-run inside each backward (the first 4 layers of
    each 5-layer chunk) and the no-grad forwards; K4 one launch per layer
    of every G backward."""
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import fused_wavenet_stack
    from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (
        wavenet_stack_backward,
    )

    steps = TRAIN_OVERRIDES["train_max_steps"]
    layers = V1_PWG_GENERATOR["layers"]
    per_call = 5  # pallas_stack_train_layers_per_call's default
    expect = {"plain": (0, 0)}
    for name, n in (("kernel", steps), ("resume", steps - 2)):
        k3 = n * (layers + layers // per_call * (per_call - 1)) + _eval_and_d_forwards() * layers
        expect[name] = (k3, n * layers)
    out = _train_runs(card, "PWG v1", _pwg_v1_config,
                      {"K3": lambda: fused_wavenet_stack.launches,
                       "K4": lambda: wavenet_stack_backward.launches},
                      expect, lambda: fused_wavenet_stack.launches, TRAIN_UTTS * layers)
    return {"k4_launches": out["launches"][1], "err": out["err"]}


def phase_melgan_train(card: str) -> dict:
    """MelGAN v1 training through ``bin/train.main`` with
    ``use_pallas_stacks_train``: K6 in every G forward (3 stages of 3
    stacks, the last with the final conv: 10 launches), the re-run inside
    each backward (stacks 0-1 of stages 1-2, all of stage 3 and its final
    conv: 8) and the no-grad forwards; K6's weight split once per stage of
    every forward (the backward's re-run reads the forward's); K7 one
    launch per stack and one for the final conv of every G backward (10)."""
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        kernel_weights,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
    )

    steps = TRAIN_OVERRIDES["train_max_steps"]
    expect = {"plain": (0, 0, 0)}
    for name, n in (("kernel", steps), ("resume", steps - 2)):
        expect[name] = (n * (10 + 8) + _eval_and_d_forwards() * 10, n * 10,
                        (n + _eval_and_d_forwards()) * 3)
    out = _train_runs(card, "MelGAN v1", _melgan_v1_config,
                      {"K6": lambda: fused_melgan_stacks.launches,
                       "K7": lambda: melgan_stacks_backward.launches,
                       "K6 weight split": lambda: kernel_weights.launches},
                      expect, lambda: fused_melgan_stacks.launches, TRAIN_UTTS * 10)
    return {"k7_launches": out["launches"][1], "err": out["err"]}


def _mb_v2_config(kernel: bool, **overrides) -> dict:
    """A fresh copy of the MB-MelGAN v2 training config, with or without
    the stack kernels (``use_pallas_stacks_train``), and with ``overrides``."""
    cfg = json.loads(json.dumps(V2_MB_CONFIG))
    cfg["generator_params"]["use_pallas_stacks_train"] = kernel
    cfg.update(overrides)
    return cfg


def phase_mb_melgan_train_split(card: str) -> None:
    """Where one MB-MelGAN v2 train step (B=64, T=16384) spends its time,
    with stages 1-2 through K6/K7 and through the plain path, and in bf16
    (``mixed_precision``) through K6/K7's bf16 modes, and K6's and K7's
    device time in one G forward and backward."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, t = V2_MB_CONFIG["batch_size"], V2_MB_CONFIG["batch_max_steps"]
    frames = t // V2_MB_CONFIG["hop_size"]
    batch = {"y": 0.3 * torch.randn(b, 1, t, generator=g, device="cuda"),
             "c": torch.randn(b, 80, frames, generator=g, device="cuda")}
    _train_split(card, "MB-MelGAN v2", lambda v: _mb_v2_config(v[0], mixed_precision=v[1]),
                 batch, forward_kernels=K6_KERNELS,
                 losses="full-band and sub-band STFT + D adversarial",
                 step_kernels=K6_KERNELS + K7_KERNELS, variants=BF16_SPLIT_VARIANTS)
    from parallelwavegan_tpu_torch.models import get_model_class

    gen = get_model_class("MelGANGenerator")(**_mb_v2_config(True)["generator_params"])
    work = {"K6": [0.0, 0.0], "K7": [0.0, 0.0]}
    for i in gen.fused_stages:
        w = gen.stage_weights(i)
        x = torch.empty((b, frames * math.prod(gen.upsample_scales[:i + 1]),
                         w["stacks"][0]["wd"].shape[-1]), device="meta")
        for name, fn in (("K6", _stacks_work), ("K7", _k7_work)):
            rec = fn(x, w["stacks"], w["final"])
            work[name][0] += rec["flops"]
            work[name][1] += rec["bytes"]
    for name, (flops, nbytes) in work.items():
        rec = _bound(flops, nbytes)
        fp32_ms = _split_tf32_bound(rec)
        print(f"MB-MelGAN v2 {name} per G step at B={b} T={t} (stages 1-2): "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; bound {rec['bound_ms']:.3f} ms "
              f"at the split-TF32 rate ({rec['bound_by']}), {fp32_ms:.3f} at the float32 "
              "rate")


def _mb_v2_cross_check(card: str) -> float:
    """One G+D ``TrainStep`` of MB-MelGAN v2 (``use_pallas_stacks_train``:
    K6/K7 on the card, their plain versions on the CPU) at B=2 x 16384, on
    the card and on the CPU from the same weights and batch: every loss to
    1e-4 relative."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import TrainStep

    cfg = _mb_v2_config(True, batch_size=2)
    g = torch.Generator().manual_seed(SEED + 1)
    t = cfg["batch_max_steps"]
    batch = {"y": 0.3 * torch.randn(2, 1, t, generator=g),
             "c": torch.randn(2, 80, t // cfg["hop_size"], generator=g)}
    got = {}
    for device in ("cuda", "cpu"):
        init = torch.Generator().manual_seed(SEED)  # the same weights on both
        gd = get_model_class(cfg["generator_type"])(
            **cfg["generator_params"], generator=init).to(device)
        dd = get_model_class(cfg["discriminator_type"])(
            **cfg["discriminator_params"], generator=init).to(device)
        step = TrainStep(cfg, gd, dd, build_criterion(cfg),
                         build_optimizer_from_config(cfg, "generator", gd.parameters()),
                         build_optimizer_from_config(cfg, "discriminator", dd.parameters()))
        t0 = time.perf_counter()
        got[device] = {k: float(v) for k, v in step(
            {k: v.to(device) for k, v in batch.items()}, True, True, 0).items()}
        print(f"MB-MelGAN v2 G+D TrainStep at B=2 T={t} on {device}: "
              f"{time.perf_counter() - t0:.1f} s (first call, host clock)")
        del gd, dd, step
    if sorted(got["cuda"]) != sorted(got["cpu"]):
        _fail(f"MB-MelGAN v2 cross-check: metrics {sorted(got['cuda'])} vs "
              f"{sorted(got['cpu'])}")
    worst = 0.0
    for key, want in got["cpu"].items():
        rel = abs(got["cuda"][key] - want) / max(abs(want), 1e-30)
        print(f"  {key}: card {got['cuda'][key]!r}, CPU {want!r}, relative {rel:.3e}")
        worst = max(worst, rel)
    print(f"MB-MelGAN v2 G+D step at B=2, card ({card}) vs CPU: max relative loss diff "
          f"{worst:.3e} over {sorted(got['cpu'])} (tol 1e-4)")
    if not worst <= 1e-4:
        _fail(f"MB-MelGAN v2 cross-check: the card and the CPU differ by {worst:.3e}")
    return worst


def phase_mb_melgan_train(card: str) -> dict:
    """MB-MelGAN v2 training through ``bin/train.main`` with
    ``use_pallas_stacks_train`` (module docstring, phase 33): K6 and K7 at
    C = 96 and 48 counted, the kernel run against the plain one, a resume,
    the decode of the checkpoint through K6 against the plain decode, a
    B=2 step on the card against the CPU, and the same 4 steps in bf16
    against K6/K7's bf16 plain versions."""
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        kernel_weights,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
    )

    steps = TRAIN_OVERRIDES["train_max_steps"]
    fwd = sum(MB_K6.values())
    expect = {"plain": (0,) * 7}
    for name, n in (("kernel", steps), ("resume", steps - 2)):
        e = _eval_and_d_forwards()
        expect[name] = (
            n * (fwd + sum(MB_K6_RERUN.values())) + e * fwd, n * sum(MB_K7.values()),
            *(n * (MB_K6[c] + MB_K6_RERUN[c]) + e * MB_K6[c] for c in (96, 48)),
            *(n * MB_K7[c] for c in (96, 48)), (n + e) * len(MB_K6))
    out = _train_runs(
        card, "MB-MelGAN v2", _mb_v2_config,
        {"K6": lambda: fused_melgan_stacks.launches,
         "K7": lambda: melgan_stacks_backward.launches,
         "K6 at C=96": lambda: fused_melgan_stacks.launches_by_width.get(96, 0),
         "K6 at C=48": lambda: fused_melgan_stacks.launches_by_width.get(48, 0),
         "K7 at C=96": lambda: melgan_stacks_backward.launches_by_width.get(96, 0),
         "K7 at C=48": lambda: melgan_stacks_backward.launches_by_width.get(48, 0),
         "K6 weight split": lambda: kernel_weights.launches},
        expect, lambda: fused_melgan_stacks.launches, MB_TRAIN_UTTS * fwd,
        utts=MB_TRAIN_UTTS, span=MB_TRAIN_FRAMES, decode_flags=("--use-pallas-stacks",),
        compare_plain_decode=True)
    cross = _mb_v2_cross_check(card)
    d_reruns = steps - TRAIN_OVERRIDES["discriminator_train_start_steps"] - 1
    bf16 = _melgan_bf16_runs(
        card, "MB-MelGAN v2", _mb_v2_config,
        (steps * (fwd + sum(MB_K6_RERUN.values())) + d_reruns * fwd,
         steps * sum(MB_K7.values())), utts=MB_TRAIN_UTTS, span=MB_TRAIN_FRAMES)
    return {"k6_launches": out["launches"][0], "k7_launches": out["launches"][1],
            "err": out["err"], "decode_err": out["decode_err"], "cross": cross,
            "k6_bf16_launches": bf16["k6_launches"], "k7_bf16_launches": bf16["k7_launches"],
            "bf16_err": bf16["err"]}


def _style_v1_config(kernel: bool, **overrides) -> dict:
    """A fresh copy of the StyleMelGAN v1 training config, with or without
    the TADE train kernels (``use_pallas_tade_train``), and with
    ``overrides``."""
    cfg = json.loads(json.dumps(V1_STYLE_CONFIG))
    cfg["generator_params"]["use_pallas_tade_train"] = kernel
    cfg.update(overrides)
    return cfg


def _style_train_blocks() -> list:
    """(block, input length, scale) of every block the train gate passes at
    StyleMelGAN v1's training input (batch_max_steps / hop = 88 frames)."""
    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import gated

    gen = get_model_class("StyleMelGANGenerator")(
        **_style_v1_config(True)["generator_params"])
    t, out = V1_STYLE_CONFIG["batch_max_steps"] // V1_FEATURES["hop_size"], []
    for i, blk in enumerate(gen.block_weights()):
        if gated(t, blk, min_fused_t=gen.min_fused_t, train=True):
            out.append((i, t, int(blk["scale"])))
        t *= int(blk["scale"])
    return out


def _k9_work(x, blk, half: int) -> dict:
    """Operations and bytes of K9a (half 1) or K9b (half 2) on a block input
    x: per row at the stage's rate, its three convs again (the re-run),
    their transposes and their weight gradients, 3 x 9 x 64 x (64 + 128 +
    128) multiply-adds; the inputs (x, c, dx2, da; or x, x2, a at T and
    dout, da2 at sT) read once, the outputs (dx, dc; or dx, dx2, da) and
    the weight gradients written once."""
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import WEIGHT_KEYS

    b, t, c = x.shape
    sc = 1 if half == 1 else int(blk["scale"])
    keys = WEIGHT_KEYS[:3] if half == 1 else WEIGHT_KEYS[3:]
    mac = 3 * sum(blk[f"{k}_w"].numel() for k in keys)
    weights = sum(blk[f"{k}{s}"].numel() for k in keys for s in ("_w", "_b"))
    acts = 6 * b * t * c if half == 1 else 6 * b * t * c + 2 * b * sc * t * c
    return _bound(2.0 * b * sc * t * mac, 4 * (acts + 2 * weights))


def _check_grads(label: str, got: dict, want: dict) -> list:
    """Each gradient of ``got`` against ``want`` by ``_grads_agree``; fails
    on a miss. Returns the max |diff| of each."""
    import torch

    errs, worst = [], (0.0, "")
    for key, r in want.items():
        g = got[key]
        if g.shape != r.shape or not torch.isfinite(g).all():
            _fail(f"{label} {key}: shapes {tuple(g.shape)} vs {tuple(r.shape)} or "
                  "non-finite gradient")
        if not _grads_agree(g, r):
            _fail(f"{label} {key}: kernel disagrees with its plain version (max|diff| "
                  f"{float((g - r).abs().max()):.3e}, max|plain| {float(r.abs().max()):.3e})")
        errs.append(float((g - r).abs().max()))
        worst = max(worst, (errs[-1] / max(float(r.abs().max()), 1e-30), key))
    print(f"{label}: {len(want)} gradients, max|diff| = {max(errs):.3e}, worst "
          f"max|diff| / max|plain| = {worst[0]:.3e} ({worst[1]}); least max|plain| "
          f"{min(float(r.abs().max()) for r in want.values()):.3e}")
    return errs


def phase_k9(card: str) -> dict:
    """K9a and K9b against their plain versions (autograd through the plain
    stage or block, forward included): StyleMelGAN v1's blocks 4-8 at the
    training shapes (B=32, T = 1408 .. 22528; random weights of unit gain
    from SEED), each stage alone, each block, the five-block chain through
    ``fused_tade_blocks_train``, ragged cases, a case without biases and one
    with T just above the backward's halo of 16 rows, under a random
    cotangent of scale 1 / sqrt(B sT), with controls that the check must
    reject; two runs bit for bit; K9a and K9b timed over blocks 4-8 beside
    their plain versions (ms, plain_ms and bound: one G step's work)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt

    blocks = _style_train_blocks()
    if [i for i, _, _ in blocks] != [4, 5, 6, 7, 8]:
        _fail(f"StyleMelGAN v1 train blocks {blocks}, expected blocks 4-8")
    b = V1_STYLE_CONFIG["batch_size"]
    rs = np.random.RandomState(SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    def random_block(scale, bias=True):  # unit-gain convs (phase 11's)
        out = {"scale": scale, "dilation": 2}
        for key in td.WEIGHT_KEYS:
            cout = 64 if key.startswith("aux") else 128
            out[f"{key}_w"] = randn(9, 64, cout, scale=1 / 24.0)
            out[f"{key}_b"] = randn(cout, scale=0.1) if bias else torch.zeros(
                cout, device="cuda")
        return out

    def named(dx_dc, dw, names=("dx", "dc")):
        return {**dict(zip(names, dx_dc)), **dw}

    cases = [(f"v1 block {i} B={b} T={t}", b, t, sc, "softmax", True)
             for i, t, sc in blocks]
    cases += [("ragged B=2 T=1002 scale 2 softmax", 2, 1002, 2, "softmax", True),
              ("ragged B=2 T=1002 scale 1 sigmoid", 2, 1002, 1, "sigmoid", True),
              ("no biases B=1 T=334 scale 2", 1, 334, 2, "softmax", False),
              ("T just above the halo B=2 T=18 scale 2", 2, 18, 2, "softmax", True)]
    k9a, k9b, chain_blocks = {"errs": []}, {"errs": []}, []
    for name, bb, t, sc, gate, bias in cases:
        blk = random_block(sc, bias)
        x, c = randn(bb, t, 64), randn(bb, t, 64)
        u = (bb * sc * t) ** -0.5
        dxo, dco = randn(bb, sc * t, 64, scale=u), randn(bb, sc * t, 64, scale=u)
        with torch.no_grad():
            x2, a = td.tade1_cuda(x, c, blk, gate)
        # each stage alone, K9a on K9b's plain cotangents
        got = tt.tade2_backward_cuda(x, x2, a, blk, gate, dxo, dco)
        torch.cuda.synchronize()
        want = tt.tade2_backward_reference(x, x2, a, blk, gate, dxo, dco)
        k9b["errs"] += _check_grads(f"K9b vs plain [{name}]",
                                    named(got[:3], got[3], ("dx", "dx2", "da")),
                                    named(want[:3], want[3], ("dx", "dx2", "da")))
        dx2r, dar = want[1].contiguous(), want[2].contiguous()
        got = tt.tade1_backward_cuda(x, c, blk, gate, dx2r, dar)
        torch.cuda.synchronize()
        want = tt.tade1_backward_reference(x, c, blk, gate, dx2r, dar)
        k9a["errs"] += _check_grads(f"K9a vs plain [{name}]", named(got[:2], got[2]),
                                    named(want[:2], want[2]))
        got = tt.tade_block_backward(x, c, x2, a, blk, gate, dxo, dco)
        torch.cuda.synchronize()
        got = named(got[:2], got[2])
        want = tt.tade_block_backward_reference(x, c, blk, gate, dxo, dco)
        want = named(want[:2], want[2])
        _check_grads(f"K9 block vs plain [{name}]", got, want)
        del got
        if name.startswith("v1 block 8"):
            # controls at the v1 shapes: wrong gradients that the check must reject
            dx = want["dx"]
            controls = {f"{key} zeroed": (torch.zeros_like(r), r) for key, r in want.items()}
            controls["dx moved 1 % toward its one-sample shift"] = (
                dx + 0.01 * (dx.roll(1, 1) - dx), dx)
            missed = [k for k, (g, r) in controls.items() if _grads_agree(g, r)]
            print(f"K9 check controls [{name}]: {len(controls) - len(missed)} of "
                  f"{len(controls)} wrong gradients rejected")
            if missed:
                _fail(f"K9's check accepts wrong gradients: {missed}")
        del want
        if name.startswith("v1"):
            chain_blocks.append(blk)
            _timed(k9a, f"K9a {name}", card,
                   lambda: tt.tade1_backward_cuda(x, c, blk, gate, dx2r, dar),
                   lambda: tt.tade1_backward_reference(x, c, blk, gate, dx2r, dar),
                   _k9_work(x, blk, 1))
            _timed(k9b, f"K9b {name} -> {sc * t}", card,
                   lambda: tt.tade2_backward_cuda(x, x2, a, blk, gate, dxo, dco),
                   lambda: tt.tade2_backward_reference(x, x2, a, blk, gate, dxo, dco),
                   _k9_work(x, blk, 2))
        torch.cuda.empty_cache()

    # the chain of blocks 4-8 through the autograd Function
    t0 = blocks[0][1]
    x0, c0 = randn(b, t0, 64), randn(b, t0, 64)
    u = (b * 16 * t0) ** -0.5
    dxo, dco = randn(b, 16 * t0, 64, scale=u), randn(b, 16 * t0, 64, scale=u)
    keys = tt.WEIGHTS

    def chain_grads(kernel: bool) -> dict:
        leaves = [x0.clone().requires_grad_(), c0.clone().requires_grad_()]
        bl = []
        for blk in chain_blocks:
            d = dict(blk, **{k: blk[k].clone().requires_grad_() for k in keys})
            bl.append(d)
            leaves += [d[k] for k in keys]
        x, c = leaves[0], leaves[1]
        if kernel:
            x, c = tt.fused_tade_blocks_train(x, c, bl, min_fused_t=1)
        else:
            for blk in bl:
                x, c = td.tade_block_reference(x, c, blk)
        names = ["dx", "dc"] + [f"blocks[{i}].{k}" for i in range(len(bl)) for k in keys]
        return dict(zip(names, torch.autograd.grad((x * dxo).sum() + (c * dco).sum(),
                                                   leaves)))

    before = (tt.tade_block_backward.launches_k9a, tt.tade_block_backward.launches_k9b)
    got = chain_grads(True)
    torch.cuda.synchronize()
    n = len(chain_blocks)
    if (tt.tade_block_backward.launches_k9a, tt.tade_block_backward.launches_k9b) != (
            before[0] + n, before[1] + n):
        _fail("the K9 chain did not launch K9a and K9b once per block")
    errs = _check_grads(f"K9 chain of blocks 4-8 vs plain [B={b} T={t0} -> {16 * t0}]",
                        got, chain_grads(False))
    k9a["errs"].append(max(errs))
    k9b["errs"].append(max(errs))
    del got

    # determinism and the profiler split, at block 8
    _, t8, sc8 = blocks[-1]
    blk = chain_blocks[-1]
    x, c = randn(b, t8, 64), randn(b, t8, 64)
    dxo, dco = randn(b, sc8 * t8, 64, scale=1e-3), randn(b, sc8 * t8, 64, scale=1e-3)
    with torch.no_grad():
        x2, a = td.tade1_cuda(x, c, blk)
    first = tt.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)
    second = tt.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(first[:2], second[:2])) and all(
        torch.equal(first[2][k], second[2][k]) for k in keys)
    print(f"K9 determinism: two runs of v1 block 8 bitwise equal = {same}")
    if not same:
        _fail("K9 gives different gradients in two runs")
    del first, second
    # K9 multiplies on the tensor cores in split TF32 (its re-run of K8 on
    # the CUDA cores): the bound is that of the units its products use
    fp32_ms = {k: _split_tf32_bound(rec) for k, rec in (("K9a", k9a), ("K9b", k9b))}
    print(f"K9 per StyleMelGAN v1 G step backward (blocks 4-8, B={b}, the re-runs "
          "included): " + ", ".join(
              f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}; bound {r['bound_ms']:.3f} "
              f"ms at the split-TF32 rate, 3 x {r['flops'] / 1e9:.1f} GFLOP / 495 TFLOP/s, "
              f"{r['bound_ms'] / r['ms']:.1%} of it; {fp32_ms[k]:.3f} ms at the float32 "
              "CUDA-core rate)" for k, r in (("K9a", k9a), ("K9b", k9b))) + f" on {card}")

    from torch.profiler import ProfilerActivity, profile

    def by_kernel(fn) -> str:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        split = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0) or 0
            if us > 0:
                short = re.sub(r"[<(].*", "", ev.key.replace("(anonymous namespace)::", ""))
                short = short.split("::")[-1].split()[-1]
                part = split.setdefault(short, [0.0, 0])
                part[0] += us / 1e3
                part[1] += ev.count
        return "; ".join(f"{n} {ms:.3f} ms ({k} launches)" for n, (ms, k) in
                         sorted(split.items(), key=lambda kv: -kv[1][0]))

    names = ("tade1_kernel and tade2_kernel are K8's re-runs, stage_bwd_kernel the "
             "transposed convs, stage_wgrad_kernel and stage_wgrad_reduce_kernel the "
             "weight gradients, the rest torch's glue")
    print(f"K9 v1 block 8 device time by kernel (torch.profiler, one backward; {names}) "
          f"on {card}: " + by_kernel(
              lambda: tt.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)))
    del x, c, x2, a, dxo, dco
    # one G step's K9 work (each of blocks 4-8 backward once), by kernel
    step = []
    for (_, t, sc), blk in zip(blocks, chain_blocks):
        x, c = randn(b, t, 64), randn(b, t, 64)
        with torch.no_grad():
            x2, a = td.tade1_cuda(x, c, blk)
        step.append((x, c, x2, a, blk, randn(b, sc * t, 64, scale=1e-3),
                     randn(b, sc * t, 64, scale=1e-3)))
    print(f"K9 per StyleMelGAN v1 G step device time by kernel (torch.profiler, blocks "
          f"4-8 backward once each; {names}) on {card}: " + by_kernel(
              lambda: [tt.tade_block_backward(x, c, x2, a, blk, "softmax", dxo, dco)
                       for x, c, x2, a, blk, dxo, dco in step]))
    del step
    torch.cuda.empty_cache()
    return {"k9a": k9a, "k9b": k9b}


def phase_style_train_split(card: str) -> None:
    """Where one StyleMelGAN v1 train step (B=32, T=22528) spends its time,
    with blocks 4-8 through K8/K9 and through the plain path, and in bf16
    (``mixed_precision``) through K8/K9's bf16 modes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, t = V1_STYLE_CONFIG["batch_size"], V1_STYLE_CONFIG["batch_max_steps"]
    frames = t // V1_STYLE_CONFIG["hop_size"]
    batch = {"y": 0.3 * torch.randn(b, 1, t, generator=g, device="cuda"),
             "c": torch.randn(b, 80, frames, generator=g, device="cuda")}
    _train_split(card, "StyleMelGAN v1",
                 lambda v: _style_v1_config(v[0], mixed_precision=v[1]), batch,
                 variants=(("kernel", (True, False)), ("plain", (False, False)),
                           ("bf16, mixed_precision, kernel", (True, True))))


def phase_style_train(card: str) -> dict:
    """StyleMelGAN v1 training through ``bin/train.main`` with
    ``use_pallas_tade_train``: K8a/K8b in every G forward (blocks 4-8: 5
    launches each) and in the no-grad forwards, K9a/K9b once per gated
    block of every G backward (5 each)."""
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import fused_tade_blocks
    from parallelwavegan_tpu_torch.ops.kernels.tade_train import tade_block_backward

    steps = TRAIN_OVERRIDES["train_max_steps"]
    n = len(_style_train_blocks())
    expect = {"plain": (0, 0, 0)}
    for name, k in (("kernel", steps), ("resume", steps - 2)):
        expect[name] = ((k + _eval_and_d_forwards()) * n, k * n, k * n)
    # decode pads the noise to 4 frames (352 mel frames) at every length in
    # STYLE_TRAIN_FRAMES: block inputs 352 .. 90112, blocks 2-8 gated
    per_utt = 7
    out = _train_runs(
        card, "StyleMelGAN v1", _style_v1_config,
        {"K8a": lambda: fused_tade_blocks.launches_k8a,
         "K9a": lambda: tade_block_backward.launches_k9a,
         "K9b": lambda: tade_block_backward.launches_k9b},
        expect, lambda: fused_tade_blocks.launches_k8a, STYLE_TRAIN_UTTS * per_utt,
        STYLE_TRAIN_UTTS, STYLE_TRAIN_FRAMES)
    return {"k9a_launches": out["launches"][1], "k9b_launches": out["launches"][2],
            "err": out["err"]}


def _hifigan_v1_config(kernel: bool = False, **overrides) -> dict:
    """A fresh copy of hifigan.v1.yaml with ``overrides``; its training runs
    no kernel (``kernel`` is for ``_train_split``'s signature)."""
    cfg = json.loads(json.dumps(V1_HIFIGAN_CONFIG))
    cfg.update(overrides)
    return cfg


def _conv_gflop(model, fn) -> float:
    """GFLOP of the convolutions of ``model`` that ``fn`` runs: two per
    multiply-add, counted from each conv's input and output shapes."""
    import math

    import torch

    total = [0]

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.ConvTranspose1d):  # each input times its taps
            total[0] += 2 * inputs[0].numel() * m.out_channels // m.groups * m.kernel_size[0]
        else:
            total[0] += 2 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(
        m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose1d))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0] / 1e9


def phase_hifigan_train_split(card: str) -> None:
    """Where one HiFi-GAN v1 train step (B=16, T=8192) spends its time, in
    float32 and in bf16 (``mixed_precision``): the
    generator, the mel loss, the five period and three scale
    discriminators with their spectral norm, feature matching; then the
    generator's and the two discriminator groups' forwards alone (no
    grad) in float32 and bf16, beside the GFLOP of their convolutions, and
    the generator forward's six kernels of most device time in each."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class

    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, t = V1_HIFIGAN_CONFIG["batch_size"], V1_HIFIGAN_CONFIG["batch_max_steps"]
    frames = t // V1_HIFIGAN_CONFIG["hop_size"]
    batch = {"y": 0.3 * torch.randn(b, 1, t, generator=g, device="cuda"),
             "c": torch.randn(b, 80, frames, generator=g, device="cuda")}
    # float32 and bf16 (mixed_precision, phase 26's config at v1's widths
    # and batch) in one call; no kernel runs on this path
    _train_split(card, "HiFi-GAN v1", lambda mixed: _hifigan_v1_config(
                     mixed_precision=mixed), batch,
                 losses="mel, D on y_, D on y for feature matching",
                 variants=(("float32", False), ("bf16, mixed_precision", True)))
    cfg = _hifigan_v1_config()
    init = torch.Generator().manual_seed(SEED)
    gen = get_model_class(cfg["generator_type"])(
        **cfg["generator_params"], generator=init).to("cuda")
    dis = get_model_class(cfg["discriminator_type"])(
        **cfg["discriminator_params"], generator=init).to("cuda")
    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import profile_by_kernel
    from parallelwavegan_tpu_torch.train import precision

    parts, tops = [], []
    with torch.no_grad():
        for name, model, x in (("G", gen, batch["c"]), ("MSD (3 scales)", dis.msd, batch["y"]),
                               ("MPD (5 periods)", dis.mpd, batch["y"])):
            # bf16: the parameters cast once, outside the timed call
            p16, x16 = precision.bf16_params(model), x.to(torch.bfloat16)
            runs = {"float32": lambda: model(x),
                    "bf16": lambda: precision.call(model, p16, x16)}
            gflop = _conv_gflop(model, runs["float32"])
            ms = {k: _median_ms(fn) for k, fn in runs.items()}
            parts.append(f"{name} ({gflop:.1f} GFLOP of convolutions) " + ", ".join(
                f"{k} {v:.3f} ms ({gflop / v:.1f} TFLOP/s)" for k, v in ms.items()))
            if name == "G":
                for k, fn in runs.items():
                    split = sorted(profile_by_kernel(fn).items(), key=lambda kv: -kv[1][0])
                    tops.append(f"{k}: " + "; ".join(
                        f"{n} {v:.3f} ms ({c} launches)" for n, (v, c) in split[:6]))
    print(f"HiFi-GAN v1 forwards alone, B={b} T={t}, no grad, D in train mode, "
          f"median of 10, CUDA events, on {card}: " + "; ".join(parts))
    print(f"HiFi-GAN v1 G forward, the six kernels of most device time (torch.profiler, "
          f"one forward) on {card}: " + " | ".join(tops))
    del gen, dis


def _spectral_vectors(path: str) -> dict:
    """The discriminator's spectral-norm (u, v) in a training checkpoint."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)["model"]["discriminator"]
    return {k[:-1] + vec: sd[k[:-1] + vec] for k in sd if k.endswith("weight_u")
            for vec in "uv"}


def _hifigan_cross_check(card: str) -> float:
    """One G+D ``TrainStep`` of v1 at B=2 x 8192 on the card and on the CPU
    from the same weights and batch (TF32 off on both): every loss to 1e-4
    relative."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import TrainStep

    cfg = _hifigan_v1_config(batch_size=2)
    g = torch.Generator().manual_seed(SEED + 1)
    t = cfg["batch_max_steps"]
    batch = {"y": 0.3 * torch.randn(2, 1, t, generator=g),
             "c": torch.randn(2, 80, t // cfg["hop_size"], generator=g)}
    got = {}
    for device in ("cuda", "cpu"):
        init = torch.Generator().manual_seed(SEED)  # the same weights on both
        gd = get_model_class(cfg["generator_type"])(
            **cfg["generator_params"], generator=init).to(device)
        dd = get_model_class(cfg["discriminator_type"])(
            **cfg["discriminator_params"], generator=init).to(device)
        step = TrainStep(cfg, gd, dd, build_criterion(cfg),
                         build_optimizer_from_config(cfg, "generator", gd.parameters()),
                         build_optimizer_from_config(cfg, "discriminator", dd.parameters()))
        t0 = time.perf_counter()
        got[device] = {k: float(v) for k, v in step(
            {k: v.to(device) for k, v in batch.items()}, True, True, 0).items()}
        print(f"HiFi-GAN v1 G+D TrainStep at B=2 T={t} on {device}: "
              f"{time.perf_counter() - t0:.1f} s (first call, host clock)")
        del gd, dd, step
    worst = 0.0
    for key, want in got["cpu"].items():
        rel = abs(got["cuda"][key] - want) / max(abs(want), 1e-30)
        if not rel <= 1e-4 or key not in got["cuda"]:
            _fail(f"HiFi-GAN v1 cross-check: {key} = {got['cuda'].get(key)!r} on the "
                  f"card vs {want!r} on the CPU")
        worst = max(worst, rel)
    if sorted(got["cuda"]) != sorted(got["cpu"]):
        _fail(f"HiFi-GAN v1 cross-check: metrics {sorted(got['cuda'])} vs "
              f"{sorted(got['cpu'])}")
    print(f"HiFi-GAN v1 G+D step, card ({card}) vs CPU: max relative loss diff "
          f"{worst:.3e} over {sorted(got['cpu'])} (tol 1e-4)")
    return worst


def phase_hifigan_train(card: str) -> dict:
    """HiFi-GAN v1 training through ``bin/train.main``: hifigan.v1.yaml at
    full width and batch with HIFIGAN_TRAIN_OVERRIDES on a dump of
    HIFIGAN_TRAIN_UTTS synthetic utterances (steps 1-4: G only, D only,
    G+D, G+D; every logged loss finite), a resume from step 2 that logs
    steps 3-4 to 1e-4 and ends on the same spectral (u, v) to 1e-6, the
    card against the CPU on one G+D step, and the trained checkpoint
    decoded through ``bin/decode.main`` with the tail kernel K1 (one launch
    per utterance) and without, the WAVs within 2e-4."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import decode, train
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import fused_hifigan_tail

    root = os.path.join(WORK, "hifigan_train")
    shutil.rmtree(root, ignore_errors=True)
    utts = HIFIGAN_TRAIN_UTTS
    dump = _write_train_dump(root, utts)
    config = os.path.join(root, "config.json")
    with open(config, "w") as f:
        json.dump(_hifigan_v1_config(**HIFIGAN_TRAIN_OVERRIDES), f)
    steps = HIFIGAN_TRAIN_OVERRIDES["train_max_steps"]
    res = {}
    for name, extra in (("run", []), ("resume", ["--resume", os.path.join(
            root, "exp_run", "checkpoint-2steps.pkl")])):
        t0 = time.perf_counter()
        res[name] = train.main(
            ["--train-dumpdir", dump, "--dev-dumpdir", dump, "--outdir",
             os.path.join(root, f"exp_{name}"), "--device", "cuda", "--verbose", "0",
             "--config", config] + extra)
        print(f"main path [HiFi-GAN v1 training, {name}]: {res[name]['steps']} steps in "
              f"{time.perf_counter() - t0:.1f} s (set-up, eval and saves included) "
              f"on {card}")
        if res[name]["steps"] != steps:
            _fail(f"HiFi-GAN v1 training {name}: {res[name]['steps']} steps")
    logged = {name: {s: {k: v for k, v in m.items() if k.startswith("train/")}
                     for s, m in r["history"] if any(k.startswith("train/") for k in m)}
              for name, r in res.items()}
    run = logged["run"]
    g_keys = {"train/mel_loss", "train/generator_loss"}
    gd_keys = g_keys | {"train/adversarial_loss", "train/feature_matching_loss",
                        "train/real_loss", "train/fake_loss", "train/discriminator_loss"}
    phases = {1: (g_keys, "train/discriminator_loss"),
              2: ({"train/real_loss", "train/fake_loss"}, "train/generator_loss"),
              3: (gd_keys, None), 4: (gd_keys, None)}
    for s, (need, absent) in phases.items():
        m = run.get(s, {})
        print(f"  step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
        if not need <= set(m) or absent in m:
            _fail(f"HiFi-GAN v1 training: step {s} logged {sorted(m)}")
        if not all(np.isfinite(v) for v in m.values()):
            _fail(f"HiFi-GAN v1 training: non-finite loss at step {s}")
    if not any("eval/feature_matching_loss" in m for _, m in res["run"]["history"]):
        _fail("HiFi-GAN v1 training: no evaluation was logged")
    if sorted(logged["resume"]) != [3, 4]:
        _fail(f"HiFi-GAN v1 resume logged steps {sorted(logged['resume'])}")
    err_resume = _losses_agree("HiFi-GAN v1 resume vs uninterrupted", logged["resume"],
                               run, (3, 4))
    ckpt = os.path.join(root, "exp_run", f"checkpoint-{steps}steps.pkl")
    a = _spectral_vectors(ckpt)
    b = _spectral_vectors(os.path.join(root, "exp_resume", f"checkpoint-{steps}steps.pkl"))
    moved = _spectral_vectors(os.path.join(root, "exp_run", "checkpoint-2steps.pkl"))
    uv_err = max(float((a[k] - b[k]).abs().max()) for k in a)
    uv_moved = max(float((a[k] - moved[k]).abs().max()) for k in a)
    if len(a) != 2 * 8 or sorted(a) != sorted(b) or not uv_err <= 1e-6:
        _fail(f"HiFi-GAN v1 resume: spectral (u, v) differ by {uv_err:.3e} ({len(a)})")
    print(f"HiFi-GAN v1 resumed from step 2 vs uninterrupted: max relative loss diff "
          f"{err_resume:.3e} over steps 3-4 (tol 1e-4); spectral (u, v) of the "
          f"{len(a) // 2} convs of scale 0: max |diff| {uv_err:.3e} (tol 1e-6), "
          f"moved {uv_moved:.3e} since step 2")
    if not uv_moved > 0:
        _fail("HiFi-GAN v1 training: the power iteration did not move (u, v)")
    cross = _hifigan_cross_check(card)

    wavdirs = {}
    for name, flags, expect in (("tail", ["--use-pallas-tail"], utts), ("plain", [], 0)):
        wavdirs[name] = os.path.join(root, f"wav_{name}")
        _reset_launch_counts()
        decode.main(["--dumpdir", dump, "--outdir", wavdirs[name], "--device", "cuda",
                     "--checkpoint", ckpt, "--verbose", "0"] + flags)
        n = len(os.listdir(wavdirs[name]))
        print(f"main path [decode of the HiFi-GAN v1 step-{steps} checkpoint, {name}]: "
              f"{n} utterances, K1 launches = {fused_hifigan_tail.launches}")
        if n != utts or fused_hifigan_tail.launches != expect:
            _fail(f"decode of the trained HiFi-GAN v1 checkpoint [{name}]: {n} WAVs, "
                  f"{fused_hifigan_tail.launches} K1 launches, expected {expect}")
    frames = [np.load(os.path.join(dump, f"utt{i}-feats.npy")).shape[0]
              for i in range(utts)]
    err = _compare_wavs(wavdirs["tail"], wavdirs["plain"], frames)
    print(f"HiFi-GAN v1 trained checkpoint, tail kernel vs plain decode: max |diff| "
          f"{err:.3e} (tol {TOL})")
    if not err <= TOL:
        _fail(f"decode of the trained HiFi-GAN v1 checkpoint: tail vs plain {err:.3e}")
    shutil.rmtree(root)
    return {"err_resume": err_resume, "cross": cross, "decode_err": err}


def _bf16_close(got, want, max_rel: float = 1e-2) -> bool:
    """The bf16 modes' bound against their plain versions: rms|diff| <=
    1e-3 rms|plain| and max|diff| <= ``max_rel`` (1e-2) max|plain|. Both
    round the same operands to bf16 and add exact products in float32 in
    other orders, so they part where a float32 value sits within that
    difference of a bf16 rounding point (one bf16 step in one operand,
    which the chain of stacks spreads: 2.8e-4 rms at C = 128, measured); a
    rounding missed, added or truncated moves every value by about 2e-3
    rms."""
    d, w = (got.float() - want.float()), want.float()
    return (float(d.pow(2).mean().sqrt()) <= 1e-3 * float(w.pow(2).mean().sqrt())
            and float(d.abs().max()) <= max_rel * float(w.abs().max()))


def _bf16_work(flops: float, nbytes: float) -> dict:
    """The bound of a bf16 mode: its operations at the tensor cores' bf16
    rate, or its bytes."""
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes}


def _bf16_stage_bytes(x, stacks, final, backward: bool) -> float:
    """Bytes one bf16 stage call must move: x, its output (and for the
    backward dy in and dx out) in bf16, the weights read in bf16 (the
    biases in float32) and, for the backward, the weight gradients written
    in float32."""
    b, t, c = x.shape
    out_ch = c if final is None else final[0].shape[-1]
    n_w = sum(st[k].numel() for st in stacks for k in ("wd", "w1", "ws"))
    n_b = sum(st[k].numel() for st in stacks for k in ("bd", "b1", "bs") if st[k] is not None)
    if final is not None:
        n_w += final[0].numel()
        n_b += 0 if final[1] is None else final[1].numel()
    acts = 2 * (x.numel() + b * t * out_ch) * (2 if backward else 1)
    return acts + 2 * n_w + 4 * n_b + (4 * (n_w + n_b) if backward else 0)


def _kernel_chain(x, stacks, final, slope, mode):
    """The inputs of stacks 1, 2, .. and of the final conv as K6's bf16 mode
    computes them in float32 (what K7's re-run keeps)."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import _run_cuda_bf16

    xs = []
    with torch.no_grad():
        _run_cuda_bf16(x, stacks, final, slope, mode, outs=xs, keep_f32=True)
    return xs


def _off_the_kinks_bf16(x, stacks, fin, mode: str, slope: float, seed: int):
    """(x, rows moved): ``_off_the_kinks`` for the bf16 mode: x is bf16, and
    the LeakyReLU inputs computed in float32 (the later stacks' inputs, each
    z, the final conv's input) are K6's bf16 chain's."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import stacks_forward_bf16

    g = torch.Generator(device=x.device).manual_seed(seed)
    moved = 0
    for _ in range(50):
        with torch.no_grad():
            fwd = stacks_forward_bf16(x, stacks, fin, slope, mode,
                                      _kernel_chain(x, stacks, fin, slope, mode))
        vals = fwd["xs"][1:] + fwd["zs"] + ([fwd["xf"]] if fin is not None else [])
        near = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
        for v in vals:
            near.logical_or_((v.abs() < 1e-5 * v.pow(2).mean().sqrt()).any(2))
        rows = near.nonzero()
        if len(rows) == 0:
            return x, moved
        x = x.float()
        x[rows[:, 0], rows[:, 1]] += 0.05 * torch.randn(
            len(rows), x.shape[2], generator=g, device=x.device)
        x = x.to(torch.bfloat16)
        moved += len(rows)
    _fail("phase 25: could not move the input off the kinks of LeakyReLU")


def phase_k67_bf16(card: str) -> dict:
    """K6's and K7's bf16-resident modes against their bf16 plain versions
    at MelGAN v1's three fused training stages and MB-MelGAN v2's two, with
    the controls that the check must reject, two runs of each for the same
    bits, their kernels' SASS, and their times beside the plain versions,
    the float32 kernels and their bf16 bounds, by part (module docstring,
    phase 25)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.time_melgan import bf16_parts

    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as m6
    from parallelwavegan_tpu_torch.ops.kernels import mma_bf16
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        _run_cuda_bf16,
        fused_melgan_stacks,
        kernel_weights_bf16,
        melgan_stacks_reference_bf16,
        stacks_forward_bf16,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        STACK_KEYS,
        melgan_stacks_backward,
        melgan_stacks_backward_reference_bf16,
    )

    # K6's and K7's bf16 modes (csrc/melgan_stack_bf16.cu,
    # csrc/melgan_stack_bwd_bf16.cu): their products on wgmma, no mma.sync
    bf16_kernels = ("stack_bf16_kernel", "dz_bf16_kernel", "dx_bf16_kernel",
                    "wgrad_bf16_kernel")
    seen = set()
    # (templated on C: K9's wgrad_bf16_kernel, csrc/tade_bwd_bf16.cu, is not)
    for kernel, use in _built_resources(
            (*(k + "<" for k in bf16_kernels), "outconv_bf16_kernel", "outconv_bwd_bf16_kernel",
             "layout_kernel"), ("melgan_stack_bf16.cu", "melgan_stack_bwd_bf16.cu")).items():
        print(f"K6/K7 bf16 {kernel}: {use.get('registers')} registers, spill stores "
              f"{use.get('spill_stores')} B, loads {use.get('spill_loads')} B; SASS "
              f"{use.get('sass')} on {card}")
        counts = use.get("sass", "")
        if kernel.startswith(bf16_kernels) and (
                not re.search(r"HGMMA\.\S*\.F32\.BF16", counts) or "TF32" in counts
                or ", HMMA 0," not in counts or use.get("spill_stores")
                or use.get("spill_loads")):
            _fail(f"{kernel}: expected bf16 warpgroup products (HGMMA ... F32.BF16), no "
                  f"HMMA and no spill, got {use}")
        seen.add(kernel.split("<")[0])
    if not seen.issuperset(bf16_kernels):
        _fail(f"K6/K7 bf16: not every one of {bf16_kernels} among the built kernels "
              f"{sorted(seen)}")

    gp = V1_MELGAN_CONFIG["generator_params"]
    b, t = V1_MELGAN_CONFIG["batch_size"], V1_MELGAN_CONFIG["batch_max_steps"]
    dils = [gp["stack_kernel_size"] ** j for j in range(gp["stacks"])]
    # (name, B, T, C, dilations, final conv's outputs, K6's max bound): v1's
    # three fused stages, then MB-MelGAN v2's two (C = 96 and 48, the final
    # conv to 4), where K6's max|diff| is held to 2e-2 of max|plain|: B=64
    # puts a million outputs in the tail, and the plain version with other
    # sums (the witness printed below) parts from it by 1.007e-2 at C = 48
    # (PERF.md §6)
    specs = [(f"v1 stage {i}", b, t >> (3 - i), 512 >> (i + 1), dils, 1 if i == 3 else 0,
              1e-2) for i in (1, 2, 3)]
    gp2 = V2_MB_CONFIG["generator_params"]
    b2 = V2_MB_CONFIG["batch_size"]
    frames2 = V2_MB_CONFIG["batch_max_steps"] // V2_MB_CONFIG["hop_size"]
    dils2 = [gp2["stack_kernel_size"] ** j for j in range(gp2["stacks"])]
    for i, c in ((1, 96), (2, 48)):
        specs.append((f"v2 stage {i}", b2, frames2 * math.prod(gp2["upsample_scales"][:i + 1]),
                      c, dils2, gp2["out_channels"] if i == 2 else 0, 2e-2))
    slope, mode = 0.2, "reflect"
    rs = np.random.RandomState(SEED + 25)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    def truncated(stacks):  # the weights cut to bf16 by truncation (a control)
        return [{k: (v.view(torch.int32) & -65536).view(torch.float32)
                 if k in ("wd", "w1", "ws") else v for k, v in st.items()} for st in stacks]

    def grads(dx, dstacks, dfinal):
        out = [("dx", dx)] + [(f"stacks[{i}].{k}", d[k]) for i, d in enumerate(dstacks)
                              for k in STACK_KEYS if d[k] is not None]
        return out + list(zip(("final w", "final b"), dfinal or ()))

    k6, k7 = {"errs": []}, {"errs": []}
    stages = []
    conv_cl = m6._conv_cl
    for j, (stage, bi, ti, c, dl, n_out, k6_max) in enumerate(specs):
        stacks = [{"wd": randn(3, c, c, scale=(3 * c) ** -0.5), "bd": randn(c, scale=0.1),
                   "w1": randn(1, c, c, scale=c ** -0.5), "b1": randn(c, scale=0.1),
                   "ws": randn(1, c, c, scale=c ** -0.5), "bs": randn(c, scale=0.1),
                   "dilation": d} for d in dl]
        fin = ((randn(7, c, n_out, scale=(7 * c) ** -0.5), randn(n_out, scale=0.1))
               if n_out else None)
        # the weights' layout kernel, bit for bit its plain version, for
        # float32 and bf16 weights
        for kind in (torch.float32, torch.bfloat16):
            sts = [{k: v.to(kind) if torch.is_tensor(v) else v for k, v in st.items()}
                   for st in stacks]
            tiles, biases = kernel_weights_bf16(sts)
            want_t, want_b = mma_bf16.stack_wgmma(sts), m6._packed_biases(sts)
            torch.cuda.synchronize()
            if not (all(torch.equal(a, w) for a, w in zip(tiles, want_t))
                    and all(torch.equal(a, w) for a, w in zip(biases, want_b))):
                _fail(f"K6/K7 bf16 {stage}: the layout kernel differs from its plain version "
                      f"({kind} weights)")
        x, moved = _off_the_kinks_bf16(randn(bi, ti, c).to(torch.bfloat16), stacks, fin, mode,
                                       slope, SEED + 1 + j)
        dy = randn(bi, ti, n_out or c, scale=(bi * ti) ** -0.5).to(torch.bfloat16)
        name = f"{stage} B={bi} T={ti} C={c}" + (f" + final to {n_out}" if fin else "")
        stages.append((name, x, stacks, fin, dy))
        # K6: the float32 chain against the plain version's; the bf16 output
        with torch.no_grad():
            out = fused_melgan_stacks(x, stacks, final=fin)
            chain = _run_cuda_bf16(x, stacks, fin, slope, mode, keep_f32=True)
            f32 = fused_melgan_stacks(x.float(), stacks, final=fin)
            trunc = _run_cuda_bf16(x, truncated(stacks), fin, slope, mode, keep_f32=True)
        want = stacks_forward_bf16(x, stacks, fin, slope, mode)["y"]
        torch.cuda.synchronize()
        if not torch.equal(out, chain.to(torch.bfloat16)):
            _fail(f"K6 bf16 {name}: the bf16 output is not its float32 chain rounded")
        if not _bf16_close(chain, want, k6_max):
            _fail(f"K6 bf16 {name}: kernel disagrees with its bf16 plain version "
                  f"(max|diff| {float((chain - want).abs().max()):.3e})")
        if _bf16_close(f32, want, k6_max) or _bf16_close(trunc, want, k6_max):
            _fail(f"K6 bf16 {name}: the check accepts the float32 kernel or truncated weights")
        with torch.no_grad():  # two runs give the same bits
            again = _run_cuda_bf16(x, stacks, fin, slope, mode, keep_f32=True)
        if not torch.equal(again, chain):
            _fail(f"K6 bf16 {name}: two runs differ")
        m6._conv_cl = _reordered_conv_cl
        try:
            wit6 = _ratios(stacks_forward_bf16(x, stacks, fin, slope, mode)["y"], want)
        finally:
            m6._conv_cl = conv_cl
        print(f"K6 bf16 [{name}]: its plain version with other sums (the witness) against "
              f"it at {wit6[0]:.3f} and {wit6[1]:.3f} of 1e-3 rms|plain| and 1e-2 max|plain|")
        d = (chain - want).float()
        k6["errs"].append(float(d.abs().max()))
        print(f"K6 bf16 vs plain [{name}]: {moved} input rows moved off the kinks; "
              f"rms|diff| / rms|plain| = {float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()):.3e}, "
              f"max|diff| / max|plain| = {float(d.abs().max() / want.abs().max()):.3e} "
              f"(bounds 1e-3 and {k6_max:g}); the float32 kernel's and the truncated "
              "weights' outputs rejected")
        del out, chain, f32, trunc, want
        # K7: its plain version fed K6's chain stack by stack
        got = grads(*melgan_stacks_backward(x, stacks, fin, slope, mode, dy))
        chain_in = _kernel_chain(x, stacks, fin, slope, mode)
        ref = grads(*melgan_stacks_backward_reference_bf16(
            x, stacks, fin, slope, mode, dy, chain_in))
        m6._conv_cl = _reordered_conv_cl
        try:
            ref_w = grads(*melgan_stacks_backward_reference_bf16(
                x, stacks, fin, slope, mode, dy, chain_in))
        finally:
            m6._conv_cl = conv_cl
        wit7 = [_ratios(w, r) for (_, w), (_, r) in zip(ref_w, ref)]
        print(f"K7 bf16 [{name}]: its plain version with other sums against it at "
              f"{max(w[0] for w in wit7):.3f} and {max(w[1] for w in wit7):.3f} of the bounds "
              "at most")
        torch.cuda.synchronize()
        worst = 0.0
        for (key, g), (_, r) in zip(got, ref):
            if g.dtype != r.dtype or g.shape != r.shape or not torch.isfinite(g.float()).all():
                _fail(f"K7 bf16 {name} {key}: {g.dtype} {tuple(g.shape)} vs {r.dtype} "
                      f"{tuple(r.shape)}, or non-finite")
            if not _bf16_close(g, r) or _bf16_close(torch.zeros_like(g), r):
                _fail(f"K7 bf16 {name} {key}: kernel disagrees with its bf16 plain version "
                      f"(max|diff| {float((g.float() - r.float()).abs().max()):.3e}, "
                      f"max|plain| {float(r.float().abs().max()):.3e})")
            dd = (g.float() - r.float())
            k7["errs"].append(float(dd.abs().max()))
            worst = max(worst, float(dd.pow(2).mean().sqrt() / r.float().pow(2).mean().sqrt()))
        again = grads(*melgan_stacks_backward(x, stacks, fin, slope, mode, dy))
        if not all(torch.equal(a, g) for (_, a), (_, g) in zip(again, got)):
            _fail(f"K7 bf16 {name}: two runs differ")
        for label, wrong in (("the float32 kernel", melgan_stacks_backward(
                x.float(), stacks, fin, slope, mode, dy.float())), ("truncated weights",
                melgan_stacks_backward(x, truncated(stacks), fin, slope, mode, dy))):
            if all(_bf16_close(g, r) for (_, g), (_, r) in zip(grads(*wrong), ref)):
                _fail(f"K7 bf16 {name}: the check accepts {label}")
        print(f"K7 bf16 vs plain [{name}]: {len(ref)} gradients, worst rms|diff| / "
              f"rms|plain| = {worst:.3e} (bound 1e-3, max 1e-2 of max|plain|); the float32 "
              "kernel's, the truncated weights' and each zeroed gradient rejected; two runs "
              "of K6 and of K7 bit-equal")
        del got, ref, again

    f32_ms = {"K6": {"v1": 0.0, "v2": 0.0}, "K7": {"v1": 0.0, "v2": 0.0}}
    parts = {"K6": {"v1": {}, "v2": {}}, "K7": {"v1": {}, "v2": {}}}
    v2 = {"K6": {}, "K7": {}}  # timed beside, not in the record's v1 step

    def add_parts(into, got):
        for part, ms in got.items():
            into[part] = into.get(part, 0.0) + ms

    for name, x, stacks, fin, dy in stages:
        cell = "v2" if name.startswith("v2") else "v1"
        r6, r7 = (v2["K6"], v2["K7"]) if cell == "v2" else (k6, k7)
        w6 = _bf16_work(_stacks_work(x, stacks, fin)["flops"],
                        _bf16_stage_bytes(x, stacks, fin, False))
        w7 = _bf16_work(_k7_work(x, stacks, fin)["flops"],
                        _bf16_stage_bytes(x, stacks, fin, True))
        # K7 reads the weights' layout that the forward made, as training does
        split = kernel_weights_bf16(stacks)
        xf, dyf = x.float(), dy.float()

        def k7_bf16():
            return melgan_stacks_backward(x, stacks, fin, slope, mode, dy, split)

        with torch.inference_mode():
            _timed(r6, f"K6 bf16 {name}", card,
                   lambda: fused_melgan_stacks(x, stacks, final=fin),
                   lambda: melgan_stacks_reference_bf16(x, stacks, final=fin), w6)
            f32_ms["K6"][cell] += _median_ms(lambda: fused_melgan_stacks(xf, stacks, final=fin))
            add_parts(parts["K6"][cell], bf16_parts(
                lambda: fused_melgan_stacks(x, stacks, final=fin),
                lambda: kernel_weights_bf16(stacks)))
        _timed(r7, f"K7 bf16 {name}", card, k7_bf16,
               lambda: melgan_stacks_backward_reference_bf16(x, stacks, fin, slope, mode, dy),
               w7)
        f32_ms["K7"][cell] += _median_ms(lambda: melgan_stacks_backward(xf, stacks, fin, slope,
                                                                        mode, dyf))
        add_parts(parts["K7"][cell], bf16_parts(k7_bf16))
    for label, rec in v2.items():
        rec.update(_bf16_work(rec["flops"], rec["bytes"]))
        print(f"{label} bf16 per MB-MelGAN v2 G step (stages 1-2, B={b2} T="
              f"{V2_MB_CONFIG['batch_max_steps']}"
              + (", K6's re-run included" if label == "K7" else ", the training forward")
              + f"): kernel {rec['ms']:.3f} ms, bf16 plain {rec['plain_ms']:.3f} ms, "
              f"float32 kernel {f32_ms[label]['v2']:.3f} ms; bf16 bound {rec['bound_ms']:.3f} "
              f"ms ({rec['flops'] / 1e9:.1f} GFLOP, {rec['bytes'] / 1e6:.1f} MB; "
              f"{rec['bound_by']}; {rec['bound_ms'] / rec['ms']:.1%} of it) on {card}")
    for label, rec in (("K6", k6), ("K7", k7)):
        rec.update(_bf16_work(rec["flops"], rec["bytes"]))
        print(f"{label} bf16 per MelGAN v1 G step (stages 1-3, B={b} T={t}"
              + (", K6's re-run included" if label == "K7" else ", the training forward")
              + f"): kernel {rec['ms']:.3f} ms, bf16 plain {rec['plain_ms']:.3f} ms, "
              f"float32 kernel {f32_ms[label]['v1']:.3f} ms; bf16 bound {rec['bound_ms']:.3f} ms "
              f"({rec['flops'] / 1e9:.1f} GFLOP / 989 TFLOP/s, {rec['bytes'] / 1e6:.1f} MB / "
              f"3.35 TB/s; {rec['bound_by']}; {rec['bound_ms'] / rec['ms']:.1%} of it) on {card}")
    for label in ("K6", "K7"):
        for cell in ("v1", "v2"):
            print(f"{label} bf16 device time by part per {cell} G step (torch.profiler): "
                  + ", ".join(f"{part} {ms:.3f} ms" for part, ms in parts[label][cell].items())
                  + f" on {card}")
    return {"k6": k6, "k7": k7}


def _checkpoint_dtypes(path: str) -> set:
    """The dtypes of every tensor in a training checkpoint (models and
    optimizers)."""
    import torch

    found = set()

    def walk(v):
        if torch.is_tensor(v):
            found.add(v.dtype)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    walk(ckpt["model"])
    walk(ckpt.get("optimizer", {}))
    return found


def _hifigan_bf16_cross_check(card: str) -> tuple:
    """One G+D ``TrainStep`` of V1_HIFIGAN_BF16_CONFIG at B=2 on the card and
    on the CPU, and in float32 on the card, from the same weights and batch:
    (max relative loss diff card vs CPU, {loss: relative diff bf16 vs
    float32}, denominator at least 0.1)."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import TrainStep

    g = torch.Generator().manual_seed(SEED + 1)
    t = V1_HIFIGAN_BF16_CONFIG["batch_max_steps"]
    batch = {"y": 0.3 * torch.randn(2, 1, t, generator=g),
             "c": torch.randn(2, 80, t // V1_HIFIGAN_BF16_CONFIG["hop_size"], generator=g)}
    got = {}
    for device, mixed in (("cuda", True), ("cpu", True), ("cuda", False)):
        cfg = dict(json.loads(json.dumps(V1_HIFIGAN_BF16_CONFIG)), batch_size=2,
                   mixed_precision=mixed)
        init = torch.Generator().manual_seed(SEED)
        gd = get_model_class(cfg["generator_type"])(
            **cfg["generator_params"], generator=init).to(device)
        dd = get_model_class(cfg["discriminator_type"])(
            **cfg["discriminator_params"], generator=init).to(device)
        step = TrainStep(cfg, gd, dd, build_criterion(cfg),
                         build_optimizer_from_config(cfg, "generator", gd.parameters()),
                         build_optimizer_from_config(cfg, "discriminator", dd.parameters()))
        got[device, mixed] = {k: float(v) for k, v in step(
            {k: v.to(device) for k, v in batch.items()}, True, True, 0).items()}
        del gd, dd, step

    def rel(a, b):
        if sorted(a) != sorted(b):
            _fail(f"HiFi-GAN v1 bf16: metrics {sorted(a)} vs {sorted(b)}")
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 0.1) for k in b}

    return (max(rel(got["cuda", True], got["cpu", True]).values()),
            rel(got["cuda", True], got["cuda", False]))


def phase_hifigan_bf16_train(card: str) -> dict:
    """HiFi-GAN v1 with ``mixed_precision`` through ``bin/train.main``
    (module docstring, phase 26)."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import train

    root = os.path.join(WORK, "hifigan_bf16")
    shutil.rmtree(root, ignore_errors=True)
    dump = _write_train_dump(root, HIFIGAN_TRAIN_UTTS)
    config = os.path.join(root, "config.json")
    with open(config, "w") as f:
        json.dump(dict(V1_HIFIGAN_BF16_CONFIG, **HIFIGAN_TRAIN_OVERRIDES), f)
    steps = HIFIGAN_TRAIN_OVERRIDES["train_max_steps"]
    res = {}
    for name, extra in (("run", []), ("resume", ["--resume", os.path.join(
            root, "exp_run", "checkpoint-2steps.pkl")])):
        t0 = time.perf_counter()
        res[name] = train.main(
            ["--train-dumpdir", dump, "--dev-dumpdir", dump, "--outdir",
             os.path.join(root, f"exp_{name}"), "--device", "cuda", "--verbose", "0",
             "--config", config] + extra)
        print(f"main path [HiFi-GAN v1 bf16 training, {name}]: {res[name]['steps']} steps "
              f"in {time.perf_counter() - t0:.1f} s (set-up, eval and saves included) "
              f"on {card}")
        if res[name]["steps"] != steps:
            _fail(f"HiFi-GAN v1 bf16 training {name}: {res[name]['steps']} steps")
    logged = {name: {s: {k: v for k, v in m.items() if k.startswith("train/")}
                     for s, m in r["history"] if any(k.startswith("train/") for k in m)}
              for name, r in res.items()}
    for s in range(1, steps + 1):
        m = logged["run"].get(s, {})
        print(f"  step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
        if not m or not all(np.isfinite(v) for v in m.values()):
            _fail(f"HiFi-GAN v1 bf16 training: step {s} logged {m}")
    if sorted(logged["resume"]) != [3, 4]:
        _fail(f"HiFi-GAN v1 bf16 resume logged steps {sorted(logged['resume'])}")
    err_resume = max(abs(logged["resume"][s][k] - v) / max(abs(v), 0.1)
                     for s in (3, 4) for k, v in logged["run"][s].items())
    dtypes = set()
    for name, s in (("run", 2), ("run", steps), ("resume", steps)):
        dtypes |= _checkpoint_dtypes(os.path.join(root, f"exp_{name}",
                                                  f"checkpoint-{s}steps.pkl"))
    import torch

    print(f"HiFi-GAN v1 bf16 resumed from step 2 vs uninterrupted: max relative loss "
          f"diff {err_resume:.3e} over steps 3-4 (bound 1e-2); checkpoint tensor types "
          f"{sorted(str(d) for d in dtypes)}")
    if not err_resume <= 1e-2:
        _fail(f"HiFi-GAN v1 bf16 resume: losses differ by {err_resume:.3e}")
    if dtypes != {torch.float32}:
        _fail(f"HiFi-GAN v1 bf16 checkpoints hold {dtypes}: the master state is float32")
    shutil.rmtree(root)
    cross, vs_f32 = _hifigan_bf16_cross_check(card)
    print(f"HiFi-GAN v1 bf16 G+D step at B=2, card ({card}) vs CPU: max relative loss "
          f"diff {cross:.3e} (bound 1e-2); bf16 vs float32 on the card: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(vs_f32.items()))
          + " (bound 3e-2; above 1e-4 somewhere: a float32 run would not pass for bf16)")
    if (not cross <= 1e-2 or not max(vs_f32.values()) <= 3e-2
            or not max(vs_f32.values()) > 1e-4):
        _fail(f"HiFi-GAN v1 bf16 cross-check: {cross:.3e} vs the CPU, {vs_f32} vs float32")
    return {"err_resume": err_resume, "cross": cross, "vs_f32": vs_f32}


def phase_melgan_bf16_train(card: str) -> dict:
    """MelGAN v1 with ``mixed_precision`` and ``use_pallas_stacks_train``
    through ``bin/train.main``, K6's and K7's bf16 launches counted, against
    the same run with their bf16 plain versions on the card (module
    docstring, phase 27)."""
    steps = TRAIN_OVERRIDES["train_max_steps"]
    d_reruns = steps - TRAIN_OVERRIDES["discriminator_train_start_steps"] - 1
    return _melgan_bf16_runs(card, "MelGAN v1", _melgan_v1_config,
                             (steps * (10 + 8) + d_reruns * 10, steps * 10))


def _reordered_conv_cl(vp, w, b, dilation: int, t: int):
    """``melgan_stack._conv_cl`` with the taps summed last to first and each
    product split in two halves of its inputs: the same function, other
    float32 sums. Patched into the bf16 plain versions, it gives a second
    plain version that parts from the first where a float32 value sits
    near a bf16 rounding point, as the kernels do (a witness of how far
    two faithful versions part)."""
    out, h = None, w.shape[1] // 2
    for k in reversed(range(w.shape[0])):
        v = vp[:, k * dilation:k * dilation + t]
        term = v[..., h:] @ w[k][h:] + v[..., :h] @ w[k][:h]
        out = term if out is None else out + term
    return out if b is None else out + b


def _ratios(got, want) -> tuple:
    """(rms|diff| / (1e-3 rms|plain|), max|diff| / (1e-2 max|plain|)):
    ``_bf16_close``'s two measures against their bounds (both <= 1 passes)."""
    d, w = (got.float() - want.float()), want.float()
    rms_d, max_d = float(d.pow(2).mean().sqrt()), float(d.abs().max())
    rms_w, max_w = float(w.pow(2).mean().sqrt()), float(w.abs().max())
    return (rms_d / (1e-3 * rms_w) if rms_w else (0.0 if rms_d == 0 else math.inf),
            max_d / (1e-2 * max_w) if max_w else (0.0 if max_d == 0 else math.inf))


def _step_states(prev: dict | None, got: dict, want: dict) -> dict:
    """How far step k of one run (``got``, its training checkpoint) lies
    from another run's step k from the same state (``want``): ``prev`` is
    the checkpoint of step k - 1 both started from, None at step 1 (the
    same seeded init, zero moments). A model whose optimizer took no step
    must come out of both bit for bit as it went in (held). For each model
    that stepped -> {"G gradient": d, ...}: rms|diff| / rms|want| over all
    its tensors of a kind: ``parameters``, the ``update`` from step k - 1,
    the optimizer's moments, and the ``gradient`` recovered from the first
    moment, g = (mu_k - b1 mu_{k-1}) / (1 - b1)."""
    import torch

    sums: dict = {}

    def note(kind, g, w):
        acc = sums.setdefault(kind, [0.0, 0.0])
        acc[0] += float((g.float() - w.float()).pow(2).sum())
        acc[1] += float(w.float().pow(2).sum())

    for model, tag in (("generator", "G"), ("discriminator", "D")):
        pg, wg = got["optimizer"][model], want["optimizer"][model]
        count = pg["param_groups"][0]["step_count"]
        before = 0 if prev is None else prev["optimizer"][model]["param_groups"][0]["step_count"]
        if count == before:  # this model took no step: nothing may have moved
            for key, v in got["model"][model].items():
                if not torch.equal(v, want["model"][model][key]) or (
                        prev is not None and not torch.equal(v, prev["model"][model][key])):
                    _fail(f"{tag} took no step but {key} moved")
            continue
        for key, v in got["model"][model].items():
            if v.is_floating_point():
                note(f"{tag} parameters", v, want["model"][model][key])
                if prev is not None:
                    p0 = prev["model"][model][key]
                    note(f"{tag} update", v - p0, want["model"][model][key] - p0)
        b1 = pg["param_groups"][0]["betas"][0]
        for i, st in pg["state"].items():
            for kind, v in st.items():
                note(f"{tag} {kind}", v, wg["state"][i][kind])
            mu0 = (0.0 if prev is None or i not in prev["optimizer"][model]["state"]
                   else prev["optimizer"][model]["state"][i]["exp_avg"])
            note(f"{tag} gradient", (st["exp_avg"] - b1 * mu0) / (1 - b1),
                 (wg["state"][i]["exp_avg"] - b1 * mu0) / (1 - b1))
    return {kind: math.sqrt(d / w) if w else 0.0 for kind, (d, w) in sorted(sums.items())}


def _melgan_bf16_runs(card: str, label: str, config_of, expect: tuple,
                      utts: int = TRAIN_UTTS, span=(150, 300)) -> dict:
    """``config_of(True, mixed_precision=True, **TRAIN_OVERRIDES)`` through
    ``bin/train.main`` on ``utts`` utterances of ``span`` frames, K6's and
    K7's bf16 launches at ``expect`` and a checkpoint after every step.
    Then, with K6's and K7's bf16 plain versions patched in on the card (no
    launch), each step k again, resumed from the kernel run's checkpoint of
    step k - 1 (step 1 from the same init): every logged loss of step k
    within 1e-2 relative (of max(|plain|, 0.1)), and a model that took no
    step unmoved (``_step_states``).

    Measured beside that and printed, not held: the state that step leaves,
    the kernel run's and (the witness) that of the plain versions with
    other float32 sums (``_reordered_conv_cl``) from the same state, each
    against the plain run's (``_step_states``); and runs left to
    themselves for all the steps: the kernel run and three plain runs, the
    plain versions again, with torch's float32 Hann window (a last-bit
    change at some taps) and with other sums, each against a plain run.
    Neither can be held to a bound: the STFT log-magnitude loss's gradient
    jumps at its clamp (0 below eps, 1 / (2 eps) of the power above it), so
    one bin that two faithful versions put on either side moves G's
    gradient by up to several times its rms, and runs left to themselves
    part by as much (PERF.md §6)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.bin import train
    from parallelwavegan_tpu_torch.ops import stft
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack as m6
    from parallelwavegan_tpu_torch.ops.kernels import melgan_stack_train as m7

    root = os.path.join(WORK, "melgan_bf16")
    shutil.rmtree(root, ignore_errors=True)
    dump = _write_train_dump(root, utts, span)
    steps = TRAIN_OVERRIDES["train_max_steps"]
    configs = {}
    for k in range(1, steps + 1):
        configs[k] = os.path.join(root, f"config_{k}.json")
        with open(configs[k], "w") as f:
            json.dump(config_of(True, mixed_precision=True, **dict(
                TRAIN_OVERRIDES, train_max_steps=k, save_interval_steps=1)), f)

    def plain_forward(x, stacks, final, slope, pad_mode, outs=None, split=None,
                      keep_f32=False):
        y = m6.stacks_forward_bf16(x, stacks, final, slope, pad_mode)["y"]
        return y if keep_f32 else y.to(torch.bfloat16)

    def plain_backward(x, stacks, final, slope, pad_mode, dy, fwd_split):
        return m7.melgan_stacks_backward_reference_bf16(x, stacks, final, slope, pad_mode, dy)

    def torch_window(win_length, device, dtype):
        return torch.hann_window(win_length, periodic=True, dtype=dtype, device=device)

    def run(name, config, resume=None):
        args = ["--train-dumpdir", dump, "--dev-dumpdir", dump, "--outdir",
                os.path.join(root, f"exp_{name}"), "--device", "cuda", "--verbose", "0",
                "--config", config]
        return train.main(args + (["--resume", resume] if resume else []))

    def from_kernel(name, k):  # step k again from the kernel run's state
        prev = os.path.join(root, "exp_kernel", f"checkpoint-{k - 1}steps.pkl")
        return run(f"{name}_{k}", configs[k], prev if k > 1 else None)

    def losses(result):
        return {s: {k: v for k, v in m.items() if k.startswith("train/")}
                for s, m in result["history"] if "train/generator_loss" in m}

    def ckpt(name, k):
        return torch.load(os.path.join(root, f"exp_{name}", f"checkpoint-{k}steps.pkl"),
                          map_location="cpu", weights_only=True)

    def apart(a, b, s):  # the loss measure at step s
        return max(abs(a[s][k] - v) / max(abs(v), 0.1) for k, v in b[s].items())

    _reset_launch_counts()
    t0 = time.perf_counter()
    kernel = run("kernel", configs[steps])
    counts = {"kernel": (m6.fused_melgan_stacks.bf16_launches,
                         m7.melgan_stacks_backward.bf16_launches)}
    print(f"main path [{label} bf16 training, kernel]: {kernel['steps']} steps in "
          f"{time.perf_counter() - t0:.1f} s on {card}; K6 bf16 launches = "
          f"{counts['kernel'][0]}, K7 bf16 launches = {counts['kernel'][1]}")
    plain, free = {}, {}
    saved = (m6._run_cuda_bf16, m7._run_cuda_bf16, m7._backward_cuda, stft.hann_window,
             m6._conv_cl)
    # the bf16 plain versions on the card, in place of K6 and K7
    m6._run_cuda_bf16 = m7._run_cuda_bf16 = plain_forward
    m7._backward_cuda = plain_backward
    try:
        _reset_launch_counts()
        t0 = time.perf_counter()
        for k in range(1, steps + 1):
            plain[k] = losses(from_kernel("plain", k))
        counts["plain"] = (m6.fused_melgan_stacks.bf16_launches,
                           m7.melgan_stacks_backward.bf16_launches)
        seconds = time.perf_counter() - t0
        for name in ("plain", "plain again"):
            free[name] = losses(run(name.replace(" ", "_"), configs[steps]))
        stft.hann_window = torch_window
        free["plain with torch's window"] = losses(run("plain_torch_window", configs[steps]))
        stft.hann_window = saved[3]
        m6._conv_cl = _reordered_conv_cl
        free["plain with other sums"] = losses(run("plain_other_sums", configs[steps]))
        for k in range(1, steps + 1):
            from_kernel("witness", k)
    finally:
        (m6._run_cuda_bf16, m7._run_cuda_bf16, m7._backward_cuda, stft.hann_window,
         m6._conv_cl) = saved
    print(f"main path [{label} bf16 training, plain]: steps 1-{steps}, each from the "
          f"kernel run's state, in {seconds:.1f} s on {card}; K6 bf16 launches = "
          f"{counts['plain'][0]}, K7 bf16 launches = {counts['plain'][1]}")
    if counts["kernel"] != expect or counts["plain"] != (0, 0):
        _fail(f"{label} bf16 training: launches {counts}, expected {expect} with the "
              "kernels")
    logged = losses(kernel)
    worst = 0.0
    for s in range(1, steps + 1):
        got, want = logged.get(s), plain[s].get(s)
        if not got or sorted(got) != sorted(want or {}) or sorted(plain[s]) != [s]:
            _fail(f"{label} bf16 training: step {s} logged {got} and {plain[s]}")
        step_worst = apart({s: got}, {s: want}, s)
        print(f"  step {s}: " + ", ".join(f"{k} {v:.6f} (plain {want[k]:.6f})"
                                          for k, v in sorted(got.items()))
              + f"; max relative diff {step_worst:.3e}")
        if not all(np.isfinite(v) for v in got.values()):
            _fail(f"{label} bf16 training: non-finite loss at step {s}")
        worst = max(worst, step_worst)
        prev = ckpt("kernel", s - 1) if s > 1 else None
        base = ckpt(f"plain_{s}", s)
        kern = _step_states(prev, ckpt("kernel", s), base)
        wit = _step_states(prev, ckpt(f"witness_{s}", s), base)
        print(f"  step {s} state, rms|diff| / rms|plain| of the kernels' (of the plain "
              "versions' with other sums, the witness) against the plain versions', not "
              "held: " + "; ".join(f"{kind} {v:.3e} ({wit.get(kind, math.nan):.3e})"
                                   for kind, v in kern.items()))
    for name, other in (("the kernels", logged), ("the plain versions again",
                                                  free["plain again"])) + tuple(
            (key, free[key]) for key in ("plain with torch's window",
                                         "plain with other sums")):
        print(f"{label} bf16 training left to itself, {name} against the plain versions: "
              "max relative loss diff by step " + ", ".join(
                  f"{s} {apart(other, free['plain'], s):.3e}" for s in range(1, steps + 1))
              + f" (not held) on {card}")
    print(f"{label} bf16 training, K6/K7 vs their bf16 plain versions, each step from the "
          f"same state: max relative loss diff {worst:.3e} over steps 1-{steps} (bound "
          f"1e-2) on {card}")
    if not worst <= 1e-2:
        _fail(f"{label} bf16 training: kernels vs plain {worst:.3e}")
    shutil.rmtree(root)
    return {"k6_launches": counts["kernel"][0], "k7_launches": counts["kernel"][1],
            "err": worst}


def _tade_bf16_work(x, blk, half: int, backward: bool) -> dict:
    """The bf16 bound of K8a/K8b (``backward`` False) or K9a/K9b on a block
    input x: its products (K9: the re-run, the transposed convs and the
    weight gradients, three times K8's) at the bf16 tensor-core rate, or
    its bytes: the activations read and written in bf16 (K8a x, c -> x2,
    a; K8b x, x2, a -> out, a2; K9a x, c, dx2, da -> dx, dc; K9b x, x2, a,
    dout, da2 -> dx, dx2, da), the weights read in bf16, the biases in
    float32 and, for K9, the weight gradients written in float32."""
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import WEIGHT_KEYS

    b, t, c = x.shape
    sc = 1 if half == 1 else int(blk["scale"])
    keys = WEIGHT_KEYS[:3] if half == 1 else WEIGHT_KEYS[3:]
    mac = sum(blk[f"{k}_w"].numel() for k in keys) * (3 if backward else 1)
    n_w = sum(blk[f"{k}_w"].numel() for k in keys)
    n_b = sum(blk[f"{k}_b"].numel() for k in keys)
    if half == 1:
        acts = (6 if backward else 4) * b * t * c
    else:
        acts = (6 * b * t * c + 2 * b * sc * t * c if backward
                else 3 * b * t * c + 2 * b * sc * t * c)
    grads = 4 * (n_w + n_b) if backward else 0
    return _bf16_work(2.0 * b * sc * t * mac, 2 * acts + 2 * n_w + 4 * n_b + grads)


def _built_resources(names, sources=("tade.cu", "tade_bwd.cu")) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads" (bytes), "sass"
    (``sass.counts``)}} of the built library's kernels whose name starts
    with one of ``names``: registers and spills from the build's own
    ``ptxas -v`` lines, SASS from the library (cuobjdump), without
    compiling again; a library loaded from an earlier build has no log,
    and then their ``sources`` are compiled once more
    (``sass.resource_usage``)."""
    from parallelwavegan_tpu_torch.ops.kernels import build, sass

    lib = build.load()
    if not lib.log:
        out = {}
        for src in sources:
            out.update(sass.resource_usage(os.path.join(build.CSRC, src)))
        return {k: v for k, v in out.items() if k.startswith(tuple(names))}
    out, entry = {}, None
    for line in lib.log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = sass.short_name(m.group(1))
            out[entry] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            out[entry]["spill_stores"], out[entry]["spill_loads"] = map(int, m.groups())
    for name, instrs in sass.kernels_of(lib.path).items():
        out.setdefault(sass.short_name(name), {})["sass"] = sass.counts(instrs)
    return {k: v for k, v in sorted(out.items()) if k.startswith(tuple(names))}


def phase_k89_bf16(card: str) -> dict:
    """The bf16-resident modes of K8a/K8b and K9a/K9b against their bf16
    plain versions at StyleMelGAN v1's training blocks 4-8 (module
    docstring, phase 28)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt
    from parallelwavegan_tpu_torch.ops.kernels.time_tade import (
        K8_PARTS,
        K9_PARTS,
        k8_parts,
        k8_pieces,
        k9_parts,
    )

    k8_bf16 = ("tade1_bf16_kernel", "tade2_bf16_kernel")
    seen = set()
    for kernel, use in _built_resources(
            ("tade1_kernel", "tade2_kernel", *k8_bf16, "stage_bwd_kernel",
             "stage_wgrad_kernel", "chain_bf16_kernel", "wgrad_bf16"),
            ("tade.cu", "tade_bf16.cu", "tade_bwd.cu", "tade_bwd_bf16.cu")).items():
        print(f"K8/K9 {kernel}: {use.get('registers')} registers, spill stores "
              f"{use.get('spill_stores')} B, loads {use.get('spill_loads')} B; SASS "
              f"{use.get('sass')} on {card}")
        counts = use.get("sass", "")
        spilled = use.get("spill_stores") or use.get("spill_loads")
        # K8's and K9's bf16 modes (csrc/tade_bf16.cu, csrc/tade_bwd_bf16.cu):
        # their products on wgmma, K8's with no mma.sync left
        if (kernel.startswith((*k8_bf16, "chain_bf16_kernel<", "wgrad_bf16_kernel"))
                and (not re.search(r"HGMMA\.\S*\.F32\.BF16", counts) or "TF32" in counts
                     or spilled or (kernel.startswith(k8_bf16) and ", HMMA 0," not in counts))):
            _fail(f"{kernel}: expected bf16 warpgroup products (HGMMA ... F32.BF16) and "
                  f"no spill, got {use}")
        seen.add(kernel.split("<")[0])
    if not seen.issuperset(k8_bf16):
        _fail(f"K8 bf16: no {k8_bf16} among the built kernels {sorted(seen)}")

    blocks = _style_train_blocks()
    b = V1_STYLE_CONFIG["batch_size"]
    rs = np.random.RandomState(SEED + 28)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    def pairs(names, got, want):
        """(name, kernel's, plain's) of each output: the named tensors,
        then a dict of weight gradients where there is one."""
        out = list(zip(names, got, want))
        if len(want) > len(names):
            out += [(k, got[-1][k], want[-1][k]) for k in want[-1]]
        return out

    def check(label: str, names, got, want, rec: dict) -> float:
        """``_bf16_close`` of each output, in its plain version's dtype;
        returns the worst rms|diff| / rms|plain|."""
        worst = 0.0
        for name, g, w in pairs(names, got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.isfinite(g.float()).all():
                _fail(f"{label} {name}: {g.dtype} {tuple(g.shape)} vs {w.dtype} "
                      f"{tuple(w.shape)}, or non-finite")
            if not _bf16_close(g, w) or _bf16_close(torch.zeros_like(g), w):
                _fail(f"{label} {name}: kernel disagrees with its bf16 plain version "
                      f"(max|diff| {float((g.float() - w.float()).abs().max()):.3e}, "
                      f"max|plain| {float(w.float().abs().max()):.3e})")
            d = g.float() - w.float()
            rec["errs"].append(float(d.abs().max()))
            worst = max(worst, float(d.pow(2).mean().sqrt() / w.float().pow(2).mean().sqrt()))
        return worst

    def rejected(label: str, control: str, names, wrong, want) -> None:
        if all(_bf16_close(g, w) for _, g, w in pairs(names, wrong, want)):
            _fail(f"{label}: the check accepts {control}")

    def same_bits(one, two) -> bool:
        """Whether two results (tensors, then a dict of gradients) are
        equal bit for bit."""
        def flat(r):
            return [t for v in r for t in (v.values() if isinstance(v, dict) else [v])]
        return all(torch.equal(a, b) for a, b in zip(flat(one), flat(two), strict=True))

    n8a, n8b, n9a, n9b = ("x2", "a"), ("out", "a2"), ("dx", "dc"), ("dx", "dx2", "da")
    recs = {k: {"errs": []} for k in ("k8a", "k8b", "k9a", "k9b")}
    f32_ms = dict.fromkeys(recs, 0.0)
    parts = {k: dict.fromkeys([*K9_PARTS, "glue"], 0.0) for k in ("k9a", "k9b")}
    k8parts = {k: dict.fromkeys(K8_PARTS, 0.0) for k in ("k8a", "k8b", "k8a_rerun", "k8b_rerun")}
    rerun_ms = {"k8a_rerun": 0.0, "k8b_rerun": 0.0}
    for i, t, sc in blocks:
        blk32 = {"scale": sc, "dilation": 2}
        for key in td.WEIGHT_KEYS:
            cout = 64 if key.startswith("aux") else 128
            blk32[f"{key}_w"] = randn(9, 64, cout, scale=1 / 24.0)
            blk32[f"{key}_b"] = randn(cout, scale=0.1)
        blk = {k: v.to(bf16) if torch.is_tensor(v) else v for k, v in blk32.items()}
        trunc = {k: (v.view(torch.int32) & -65536).view(torch.float32)
                 if k.endswith("_w") else v for k, v in blk32.items()}
        x, c = randn(b, t, 64).to(bf16), randn(b, t, 64).to(bf16)
        u = (b * sc * t) ** -0.5
        dout, da2 = (randn(b, sc * t, 64, scale=u).to(bf16) for _ in range(2))
        name = f"v1 block {i} B={b} T={t}" + (f" -> {sc * t}" if sc > 1 else "")
        with torch.no_grad():
            x2, a = td.tade1_cuda(x, c, blk)
            got8b = td.tade2_cuda(x, x2, a, blk)
            want8a = td.tade1_reference_bf16(x, c, blk)
            want8b = td.tade2_reference_bf16(x, x2, a, blk)
        w8a = check(f"K8a bf16 {name}", n8a, (x2, a), want8a, recs["k8a"])
        w8b = check(f"K8b bf16 {name}", n8b, got8b, want8b, recs["k8b"])
        with torch.no_grad():
            if not (same_bits((x2, a), td.tade1_cuda(x, c, blk))
                    and same_bits(got8b, td.tade2_cuda(x, x2, a, blk))):
                _fail(f"K8 bf16 {name}: two runs of the same inputs differ")
        with torch.no_grad():
            xf, cf, x2f, af = x.float(), c.float(), x2.float(), a.float()
            for control, w8, w8b_ in (
                    ("the float32 kernels", td.tade1_cuda(xf, cf, blk32),
                     td.tade2_cuda(xf, x2f, af, blk32)),
                    ("truncated weights", td.tade1_cuda(x, c, trunc),
                     td.tade2_cuda(x, x2, a, trunc))):
                rejected(f"K8a bf16 {name}", control, n8a, w8, want8a)
                rejected(f"K8b bf16 {name}", control, n8b, w8b_, want8b)
        del got8b, want8a, want8b, w8, w8b_
        # K9, stage by stage: each plain version fed the kernel's own re-run
        got9b = tt.tade2_backward_cuda(x, x2, a, blk, "softmax", dout, da2)
        dx2, da = got9b[1], got9b[2]
        got9a = tt.tade1_backward_cuda(x, c, blk, "softmax", dx2, da)
        # two runs give the same bits (fixed-order sums, no atomics)
        if not (same_bits(got9b, tt.tade2_backward_cuda(x, x2, a, blk, "softmax", dout, da2))
                and same_bits(got9a, tt.tade1_backward_cuda(x, c, blk, "softmax", dx2, da))):
            _fail(f"K9 bf16 {name}: two runs of the same inputs differ")
        with torch.no_grad():
            m2, r2 = td._stats(x2.float())
            m1, r1 = td._stats(x.float())
            rerun2 = tt.tade2_rerun_cuda(x, x2, a, blk, "softmax", m2, r2)
            rerun1 = tt.tade1_rerun_cuda(x, c, blk, "softmax", m1, r1)
            # the Save re-runs against their plain versions, and twice
            want1 = tt.tade1_rerun_reference_bf16(x, c, blk, "softmax", m1, r1)
            want2 = [v for v in tt.tade2_rerun_reference_bf16(x, x2, a, blk, "softmax", m2, r2)
                     if v is not None]
            w8r = max(check(f"K8a bf16 re-run {name}", ("a", "y", "s", "t"), rerun1, want1,
                            recs["k8a"]),
                      check(f"K8b bf16 re-run {name}", ("a2", "y", "s", "t", "ua"),
                            [v for v in rerun2 if v is not None], want2, recs["k8b"]))
            if not (same_bits(rerun1, tt.tade1_rerun_cuda(x, c, blk, "softmax", m1, r1))
                    and same_bits([v for v in rerun2 if v is not None],
                                  [v for v in tt.tade2_rerun_cuda(x, x2, a, blk, "softmax",
                                                                  m2, r2) if v is not None])):
                _fail(f"K8 bf16 re-run {name}: two runs of the same inputs differ")
            del want1, want2
        want9b = tt.tade2_backward_reference_bf16(x, x2, a, blk, "softmax", dout, da2, rerun2)
        want9a = tt.tade1_backward_reference_bf16(x, c, blk, "softmax", dx2, da, rerun1)
        del rerun1, rerun2
        w9b = check(f"K9b bf16 {name}", n9b, got9b, want9b, recs["k9b"])
        w9a = check(f"K9a bf16 {name}", n9a, got9a, want9a, recs["k9a"])
        for control, g9b, g9a in (
                ("the float32 kernels",
                 tt.tade2_backward_cuda(xf, x2f, af, blk32, "softmax", dout.float(),
                                        da2.float()),
                 tt.tade1_backward_cuda(xf, cf, blk32, "softmax", dx2.float(), da.float())),
                ("truncated weights",
                 tt.tade2_backward_cuda(x, x2, a, trunc, "softmax", dout, da2),
                 tt.tade1_backward_cuda(x, c, trunc, "softmax", dx2, da))):
            rejected(f"K9b bf16 {name}", control, n9b, g9b, want9b)
            rejected(f"K9a bf16 {name}", control, n9a, g9a, want9a)
        del got9a, got9b, want9a, want9b, g9a, g9b
        print(f"K8/K9 bf16 vs plain [{name}]: worst rms|diff| / rms|plain| K8a {w8a:.3e}, "
              f"K8b {w8b:.3e}, their Save re-runs {w8r:.3e}, K9a {w9a:.3e}, K9b {w9b:.3e} "
              "(bound 1e-3, max 1e-2 of max|plain|; K9 fed the kernels' re-run); the float32 "
              "kernels' and the truncated weights' results rejected; two runs bit-equal")
        with torch.no_grad():
            _timed(recs["k8a"], f"K8a bf16 {name}", card, lambda: td.tade1_cuda(x, c, blk),
                   lambda: td.tade1_reference_bf16(x, c, blk),
                   _tade_bf16_work(x, blk, 1, False))
            _timed(recs["k8b"], f"K8b bf16 {name}", card,
                   lambda: td.tade2_cuda(x, x2, a, blk),
                   lambda: td.tade2_reference_bf16(x, x2, a, blk),
                   _tade_bf16_work(x, blk, 2, False))
            f32_ms["k8a"] += _median_ms(lambda: td.tade1_cuda(xf, cf, blk32))
            f32_ms["k8b"] += _median_ms(lambda: td.tade2_cuda(xf, x2f, af, blk32))
            k8 = {"k8a": (lambda: td.tade1_cuda(x, c, blk), 1, x, False),
                  "k8b": (lambda: td.tade2_cuda(x, x2, a, blk), 2, x2, False),
                  "k8a_rerun": (lambda: tt.tade1_rerun_cuda(x, c, blk, "softmax", m1, r1), 1,
                                x, True),
                  "k8b_rerun": (lambda: tt.tade2_rerun_cuda(x, x2, a, blk, "softmax", m2, r2),
                                2, x2, True)}
            for key, (fn, half, v, rerun) in k8.items():
                if rerun:
                    rerun_ms[key] += _median_ms(fn)
                for part, ms in k8_parts(fn, k8_pieces(td, half, v, blk, rerun)).items():
                    k8parts[key][part] += ms
        _timed(recs["k9a"], f"K9a bf16 {name}", card,
               lambda: tt.tade1_backward_cuda(x, c, blk, "softmax", dx2, da),
               lambda: tt.tade1_backward_reference(x, c, blk, "softmax", dx2, da),
               _tade_bf16_work(x, blk, 1, True))
        _timed(recs["k9b"], f"K9b bf16 {name}", card,
               lambda: tt.tade2_backward_cuda(x, x2, a, blk, "softmax", dout, da2),
               lambda: tt.tade2_backward_reference(x, x2, a, blk, "softmax", dout, da2),
               _tade_bf16_work(x, blk, 2, True))
        for key, fn in (("k9a", lambda: tt.tade1_backward_cuda(x, c, blk, "softmax", dx2, da)),
                        ("k9b", lambda: tt.tade2_backward_cuda(x, x2, a, blk, "softmax", dout,
                                                               da2))):
            for part, ms in k9_parts(fn).items():
                parts[key][part] += ms
        dx2f, daf, doutf, da2f = dx2.float(), da.float(), dout.float(), da2.float()
        f32_ms["k9a"] += _median_ms(
            lambda: tt.tade1_backward_cuda(xf, cf, blk32, "softmax", dx2f, daf))
        f32_ms["k9b"] += _median_ms(
            lambda: tt.tade2_backward_cuda(xf, x2f, af, blk32, "softmax", doutf, da2f))
        del x, c, x2, a, xf, cf, x2f, af, dx2, da, dout, da2, dx2f, daf, doutf, da2f
        torch.cuda.empty_cache()
    for label, rec in recs.items():
        rec.update(_bf16_work(rec["flops"], rec["bytes"]))
        print(f"{label.upper()} bf16 per StyleMelGAN v1 G step (blocks 4-8, B={b}"
              + (", the re-run and the glue included" if label.startswith("k9") else
                 ", the training forward") + f"): kernel {rec['ms']:.3f} ms, bf16 plain "
              f"{rec['plain_ms']:.3f} ms, float32 kernel {f32_ms[label]:.3f} ms; bf16 bound "
              f"{rec['bound_ms']:.3f} ms ({rec['flops'] / 1e9:.1f} GFLOP / 989 TFLOP/s, "
              f"{rec['bytes'] / 1e6:.1f} MB / 3.35 TB/s; {rec['bound_by']}; "
              f"{rec['bound_ms'] / rec['ms']:.1%} of it) on {card}")
    for label, split in k8parts.items():
        rerun = label.endswith("rerun")
        base = recs[label[:3]]
        ms = rerun_ms[label] if rerun else base["ms"]
        print(f"{label[:3].upper()} bf16, "
              + ("the Save re-run inside K9" if rerun else "the forward")
              + ", by part per StyleMelGAN v1 G step (torch.profiler device time): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
              + f"; {ms:.3f} ms by CUDA events; the kernel at "
              + (f"{base['bound_ms'] / split['kernel']:.1%}" if split["kernel"] else
                 "(not in the trace)") + f" of the bf16 bound {base['bound_ms']:.3f} ms on {card}")
        base["rerun_parts" if rerun else "parts"] = split
        if rerun:
            base["rerun_ms"] = ms
    for label, split in parts.items():
        # the transposed convs and weight gradients are two thirds of K9's
        # products (the re-run the third)
        own_ms = 2 / 3 * recs[label]["flops"] / PEAK_BF16 * 1e3
        work_ms = split["chain"] + split["weight gradients"]
        print(f"{label.upper()} bf16 by part per StyleMelGAN v1 G step (torch.profiler device "
              f"time): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
              + f"; sum {sum(split.values()):.3f} ms against {recs[label]['ms']:.3f} ms by "
              f"CUDA events; chain + weight gradients {work_ms:.3f} ms, "
              + (f"{own_ms / work_ms:.1%}" if work_ms else "share not measured")
              + f" of their bf16 bound {own_ms:.3f} ms on {card}")
        recs[label]["parts"] = split
    return recs


def _style_bf16_cross_check(card: str) -> tuple:
    """One G+D ``TrainStep`` of StyleMelGAN v1 with ``mixed_precision`` and
    ``use_pallas_tade_train`` at B=2 on the card (the bf16 kernels) and on
    the CPU (their bf16 plain versions), and in float32 on the card, from
    the same weights and batch (z given): (max relative loss diff card vs
    CPU, {loss: relative diff bf16 vs float32}, denominator at least 0.1)."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import TrainStep

    g = torch.Generator().manual_seed(SEED + 29)
    t = V1_STYLE_CONFIG["batch_max_steps"]
    gp = V1_STYLE_CONFIG["generator_params"]
    batch = {"y": 0.3 * torch.randn(2, 1, t, generator=g),
             "c": torch.randn(2, 80, t // V1_STYLE_CONFIG["hop_size"], generator=g),
             "z": torch.randn(2, gp["in_channels"], 1, generator=g)}
    got = {}
    for device, mixed in (("cuda", True), ("cpu", True), ("cuda", False)):
        cfg = _style_v1_config(True, batch_size=2, mixed_precision=mixed)
        init = torch.Generator().manual_seed(SEED)
        gd = get_model_class(cfg["generator_type"])(
            **cfg["generator_params"], generator=init).to(device)
        dd = get_model_class(cfg["discriminator_type"])(
            **cfg["discriminator_params"], generator=init).to(device)
        step = TrainStep(cfg, gd, dd, build_criterion(cfg),
                         build_optimizer_from_config(cfg, "generator", gd.parameters()),
                         build_optimizer_from_config(cfg, "discriminator", dd.parameters()))
        got[device, mixed] = {k: float(v) for k, v in step(
            {k: v.to(device) for k, v in batch.items()}, True, True, 0).items()}
        del gd, dd, step

    def rel(a, b):
        if sorted(a) != sorted(b):
            _fail(f"StyleMelGAN v1 bf16: metrics {sorted(a)} vs {sorted(b)}")
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 0.1) for k in b}

    return (max(rel(got["cuda", True], got["cpu", True]).values()),
            rel(got["cuda", True], got["cuda", False]))


def phase_style_bf16_train(card: str) -> dict:
    """StyleMelGAN v1 with ``mixed_precision`` and ``use_pallas_tade_train``
    through ``bin/train.main``, the bf16 launches of K8a/K8b and K9a/K9b
    counted, against the same run with their bf16 plain versions on the
    card, and a resume (module docstring, phase 29)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.bin import train
    from parallelwavegan_tpu_torch.ops.kernels import tade_decode as td
    from parallelwavegan_tpu_torch.ops.kernels import tade_train as tt

    root = os.path.join(WORK, "style_bf16")
    shutil.rmtree(root, ignore_errors=True)
    dump = _write_train_dump(root, STYLE_TRAIN_UTTS, STYLE_TRAIN_FRAMES)
    config = os.path.join(root, "config.json")
    with open(config, "w") as f:
        json.dump(_style_v1_config(True, mixed_precision=True, **TRAIN_OVERRIDES), f)
    steps = TRAIN_OVERRIDES["train_max_steps"]
    n = len(_style_train_blocks())
    # bf16: the G phases' forwards and the D phases' re-runs, and one Save
    # re-run of K8a and of K8b inside each K9a and K9b; the eval's two
    # forwards run in float32 (K8's float32 mode), as the trainer's eval does
    d_reruns = steps - TRAIN_OVERRIDES["discriminator_train_start_steps"] - 1
    expect = {}
    for name, k in (("kernel", steps), ("plain", 0), ("resume", steps - 2)):
        fwd = (k + d_reruns) * n if k else 0
        expect[name] = (fwd, fwd, k * n, k * n,
                        (k + _eval_and_d_forwards()) * n if k else 2 * n, k * n, k * n)

    saved = (tt.tade1_cuda, tt.tade2_cuda, tt.tade1_backward_cuda, tt.tade2_backward_cuda)

    def plain(bf16_version, kernel):
        """The bf16 plain version on a bf16 input, else the float32 kernel
        (the eval's forwards)."""
        def run(x, *args):
            if x.dtype != torch.bfloat16:
                return kernel(x, *args)
            return tuple(v.contiguous() if torch.is_tensor(v) else v
                         for v in bf16_version(x, *args))
        return run

    res, counts = {}, {}
    for name, extra in (("kernel", []), ("plain", []), ("resume", ["--resume", os.path.join(
            root, "exp_kernel", "checkpoint-2steps.pkl")])):
        if name == "plain":  # the bf16 plain versions on the card, in place of K8 and K9
            tt.tade1_cuda = plain(td.tade1_reference_bf16, saved[0])
            tt.tade2_cuda = plain(td.tade2_reference_bf16, saved[1])
            tt.tade1_backward_cuda = plain(tt.tade1_backward_reference_bf16, saved[2])
            tt.tade2_backward_cuda = plain(tt.tade2_backward_reference_bf16, saved[3])
        try:
            _reset_launch_counts()
            t0 = time.perf_counter()
            res[name] = train.main(
                ["--train-dumpdir", dump, "--dev-dumpdir", dump, "--outdir",
                 os.path.join(root, f"exp_{name}"), "--device", "cuda", "--verbose", "0",
                 "--config", config] + extra)
            seconds = time.perf_counter() - t0
            counts[name] = (td.fused_tade_blocks.bf16_launches_k8a,
                            td.fused_tade_blocks.bf16_launches_k8b,
                            tt.tade_block_backward.bf16_launches_k9a,
                            tt.tade_block_backward.bf16_launches_k9b,
                            td.fused_tade_blocks.launches_k8a,
                            td.fused_tade_blocks.bf16_rerun_launches_k8a,
                            td.fused_tade_blocks.bf16_rerun_launches_k8b)
        finally:
            (tt.tade1_cuda, tt.tade2_cuda, tt.tade1_backward_cuda,
             tt.tade2_backward_cuda) = saved
        print(f"main path [StyleMelGAN v1 bf16 training, {name}]: {res[name]['steps']} "
              f"steps in {seconds:.1f} s (set-up, eval and saves included) on {card}; bf16 "
              "launches " + ", ".join(f"{k} {v}" for k, v in zip(
                  ("K8a", "K8b", "K9a", "K9b"), counts[name]))
              + f"; K8a launches in all {counts[name][4]} (the eval's float32); bf16 Save "
              f"re-runs inside K9 K8a {counts[name][5]}, K8b {counts[name][6]}")
        if res[name]["steps"] != steps or counts[name] != expect[name]:
            _fail(f"StyleMelGAN v1 bf16 training {name}: {res[name]['steps']} steps, "
                  f"launches {counts[name]}, expected {expect[name]}")
    logged = {name: {s: {k: v for k, v in m.items() if k.startswith("train/")}
                     for s, m in r["history"] if "train/generator_loss" in m}
              for name, r in res.items()}
    worst = 0.0
    for s in range(1, steps + 1):
        got, want = logged["kernel"].get(s), logged["plain"].get(s)
        if not got or sorted(got) != sorted(want or {}):
            _fail(f"StyleMelGAN v1 bf16 training: step {s} logged {got} and {want}")
        print(f"  step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(got.items())))
        if not all(np.isfinite(v) for v in got.values()):
            _fail(f"StyleMelGAN v1 bf16 training: non-finite loss at step {s}")
        worst = max([worst] + [abs(got[k] - v) / max(abs(v), 0.1) for k, v in want.items()])
    if "train/discriminator_loss" not in logged["kernel"].get(steps, {}):
        _fail("StyleMelGAN v1 bf16 training: the D phase did not run")
    if sorted(logged["resume"]) != [3, 4]:
        _fail(f"StyleMelGAN v1 bf16 resume logged steps {sorted(logged['resume'])}")
    err_resume = max(abs(logged["resume"][s][k] - v) / max(abs(v), 0.1)
                     for s in (3, 4) for k, v in logged["kernel"][s].items())
    dtypes = set()
    for name, s in (("kernel", 2), ("kernel", steps), ("resume", steps)):
        dtypes |= _checkpoint_dtypes(os.path.join(root, f"exp_{name}",
                                                  f"checkpoint-{s}steps.pkl"))
    print(f"StyleMelGAN v1 bf16 training, K8/K9 vs their bf16 plain versions: max relative "
          f"loss diff {worst:.3e} over steps 1-{steps} (bound 1e-2); resumed from step 2 vs "
          f"uninterrupted {err_resume:.3e} over steps 3-4 (bound 1e-2); checkpoint tensor "
          f"types {sorted(str(d) for d in dtypes)} on {card}")
    if not worst <= 1e-2 or not err_resume <= 1e-2:
        _fail(f"StyleMelGAN v1 bf16 training: kernels vs plain {worst:.3e}, resume "
              f"{err_resume:.3e}")
    if dtypes != {torch.float32}:
        _fail(f"StyleMelGAN v1 bf16 checkpoints hold {dtypes}: the master state is float32")
    shutil.rmtree(root)
    cross, vs_f32 = _style_bf16_cross_check(card)
    print(f"StyleMelGAN v1 bf16 G+D step at B=2, card ({card}, K8/K9 bf16) vs CPU (their "
          f"bf16 plain versions): max relative loss diff {cross:.3e} (bound 1e-2); bf16 vs "
          "float32 on the card: " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(vs_f32.items()))
          + " (bound 3e-2; above 1e-4 somewhere: a float32 run would not pass for bf16)")
    if (not cross <= 1e-2 or not max(vs_f32.values()) <= 3e-2
            or not max(vs_f32.values()) > 1e-4):
        _fail(f"StyleMelGAN v1 bf16 cross-check: {cross:.3e} vs the CPU, {vs_f32} vs float32")
    return {"k8a_launches": counts["kernel"][0], "k8b_launches": counts["kernel"][1],
            "k9a_launches": counts["kernel"][2], "k9b_launches": counts["kernel"][3],
            "k8a_reruns": counts["kernel"][5], "k8b_reruns": counts["kernel"][6],
            "err": worst, "err_resume": err_resume, "cross": cross}


# K3's bf16 mode: the check of one layer fed the plain version's input (the
# PR 16/17 rule and the share of bit-equal residuals), and of a whole cycle
# against the chain's own noise; the CPU floors they rest on are in
# PERF.md (PR 18): one layer, the plain version against itself with float64
# sums, 3.5e-5 rms on x and 1.8e-5 on the skip with 99.98 % of x bit-equal;
# a v1 cycle 3.2e-3 rms on x (53.5 % bit-equal) and 1.2e-3 on the skip; the
# v1 generator's output 2.7e-3 rms.
K3_BF16_LAYER_EQUAL = 0.99
K3_BF16_CYCLE_EQUAL = 0.25
K3_BF16_CYCLE_SKIP_RMS = 2.5e-3
K3_BF16_DECODE_RMS = 5e-3
# csrc/wavenet_bf16.cu runs one block of 256 threads an SM (its stages and
# resident weights take 225 KB at v1), so a thread may hold 255 registers
K3_BF16_MAX_REGISTERS = 255


def _rms_max_equal(got, want) -> tuple:
    """(rms|diff| / rms|want|, max|diff| / max|want|, share of bit-equal
    elements, max|diff|); fails on a wrong shape or non-finite output."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        _fail(f"shapes {tuple(got.shape)} vs {tuple(want.shape)} or non-finite output")
    d, w = got.float() - want.float(), want.float()
    return (float(d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()),
            float(d.abs().max() / w.abs().max()), float((got == want).float().mean()),
            float(d.abs().max()))


def _k3_bf16_layer_ok(got, want) -> bool:
    """One layer of K3's bf16 mode against its plain version on the same
    input: x_out and skip within the PR 16/17 rule (``_bf16_close``) and x_out
    bit-equal in at least K3_BF16_LAYER_EQUAL of its elements."""
    return (all(_bf16_close(g, r) for g, r in zip(got, want))
            and _rms_max_equal(got[0], want[0])[2] >= K3_BF16_LAYER_EQUAL)


def _k3_bf16_cycle_ok(got, want) -> bool:
    """A whole cycle against the plain version: at least K3_BF16_CYCLE_EQUAL
    of x bit-equal, the skip within K3_BF16_CYCLE_SKIP_RMS rms and 1e-2 max
    of the plain version's."""
    sx, ss = _rms_max_equal(got[0], want[0]), _rms_max_equal(got[1], want[1])
    return sx[2] >= K3_BF16_CYCLE_EQUAL and ss[0] <= K3_BF16_CYCLE_SKIP_RMS and ss[1] <= 1e-2


def phase_k3_bf16(card: str) -> dict:
    """K3's bf16-resident mode against its bf16 plain version at a PWG v1
    cycle and a ragged C = 16 cycle, layer by layer and whole, with three
    controls, bitwise reruns, its build resources and its times (module
    docstring, phase 30)."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn

    for kernel, use in _built_resources(("wavenet_layer_kernel", "wavenet_bf16_kernel"),
                                        ("wavenet.cu", "wavenet_bf16.cu")).items():
        print(f"K3/K5 {kernel}: {use.get('registers')} registers, spill stores "
              f"{use.get('spill_stores')} B, loads {use.get('spill_loads')} B; SASS "
              f"{use.get('sass')}")
        sass = use.get("sass", "")
        if kernel.startswith("wavenet_bf16_kernel") and (
                use.get("spill_stores") or use.get("spill_loads")
                or use.get("registers", 999) > K3_BF16_MAX_REGISTERS
                or not re.search(r"HGMMA\.\S*F32\.BF16", sass) or "HMMA 0," not in sass):
            _fail(f"K3's bf16 kernel {kernel}: spills, more than {K3_BF16_MAX_REGISTERS} "
                  "registers, no bf16 HGMMA or an HMMA")

    def trunc(v):  # float32 weights cut to bf16 by truncation (a control)
        return (v.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)

    gen = _pwg_v1({"use_pallas_stack_train": False, "use_pallas_stack": True,
                   "pallas_stack_bf16": True})
    n = V1_PWG_GENERATOR["layers"] // V1_PWG_GENERATOR["stacks"]
    all_w, all_d = gen._kernel_cache["stack"]  # with decode's bf16 fragments
    v1 = ({k: v[:n] for k, v in all_w.items()}, tuple(all_d[:n]))
    rs = np.random.RandomState(SEED)
    ragged = {key: torch.from_numpy((rs.randn(*shape) * (2.0 / fan) ** 0.5).astype(
        np.float32)).to("cuda") for key, shape, fan in (
        ("wconv", (n, 3, 16, 32), 48), ("bconv", (n, 32), 4), ("waux", (n, 10, 32), 10),
        ("wskip", (n, 16, 16), 16), ("bskip", (n, 16), 4), ("wres", (n, 16, 16), 16),
        ("bres", (n, 16), 4))}
    cases = (("v1 cycle", 1, 131072, 80, v1[0], v1[1]),
             ("ragged C=16", 3, 777, 10, wn.with_tiles_bf16(ragged),
              tuple(2 ** i for i in range(n))))
    rec, bf16 = {"errs": []}, torch.bfloat16
    with torch.inference_mode():
        for name, b, t, ca, w, dil in cases:
            ch = w["wres"].shape[-1]
            x = torch.from_numpy(rs.randn(b, t, ch).astype(np.float32)).to("cuda")
            c = torch.from_numpy(rs.randn(b, t, ca).astype(np.float32)).to("cuda")
            plain_w = {k: w[k] for k in wn.WEIGHT_KEYS}
            worst = {"kernel": [0.0, 0.0, 1.0, 0.0]}
            counts0 = (wn.fused_wavenet_stack.bf16_calls, wn.fused_wavenet_stack.bf16_launches)
            rejected = {"float32 kernel": 0, "weights truncated to bf16": 0,
                        "g unrounded (plain version)": 0}
            xl = x
            for li, d in enumerate(dil):
                wl = {k: v[li:li + 1] for k, v in w.items()}
                pl = {k: wl[k] for k in wn.WEIGHT_KEYS}
                want = wn.wavenet_stack_reference_bf16(xl, c, pl, (d,))
                got = wn.fused_wavenet_stack(xl, c, wl, (d,), bf16)
                torch.cuda.synchronize()
                sx, ss = _rms_max_equal(got[0], want[0]), _rms_max_equal(got[1], want[1])
                worst["kernel"] = [max(worst["kernel"][0], sx[0], ss[0]),
                                   max(worst["kernel"][1], sx[1], ss[1]),
                                   min(worst["kernel"][2], sx[2]),
                                   max(worst["kernel"][3], sx[3], ss[3])]
                if not _k3_bf16_layer_ok(got, want):
                    _fail(f"K3 bf16 {name} layer {li} (d={d}): x {sx}, skip {ss} against "
                          "its plain version")
                controls = {
                    "float32 kernel": wn.fused_wavenet_stack(xl, c, pl, (d,)),
                    "weights truncated to bf16": wn.fused_wavenet_stack(
                        xl, c, {k: trunc(v) if k[0] == "w" else v for k, v in pl.items()},
                        (d,), bf16),
                    "g unrounded (plain version)": wn.wavenet_stack_reference_bf16(
                        xl, c, pl, (d,), round_g=False),
                }
                for cname, out in controls.items():
                    rejected[cname] += not _k3_bf16_layer_ok(out, want)
                xl = want[0]
            rec["errs"].append(worst["kernel"][3])
            print(f"K3 bf16 vs plain [{name}, B={b} T={t} C={ch} Ca={ca}, each of "
                  f"{len(dil)} layers fed the plain version's input]: worst rms|diff| "
                  f"{worst['kernel'][0]:.2e} of rms|plain| (bound 1e-3), max "
                  f"{worst['kernel'][1]:.2e} of max|plain| (bound 1e-2), least share of x "
                  f"bit-equal {worst['kernel'][2]:.5f} (bound {K3_BF16_LAYER_EQUAL}), max|diff| "
                  f"{worst['kernel'][3]:.3e}")
            for cname, count in rejected.items():
                print(f"K3 bf16 check control [{name}, {cname}]: rejected at {count} of "
                      f"{len(dil)} layers")
                if count != len(dil):
                    _fail(f"phase 30's layer check accepts {cname} ({name})")
            got = wn.fused_wavenet_stack(x, c, w, dil, bf16)
            again = wn.fused_wavenet_stack(x, c, w, dil, bf16)
            fresh = wn.fused_wavenet_stack(x, c, plain_w, dil, bf16)  # rounded per call
            want = wn.wavenet_stack_reference_bf16(x, c, plain_w, dil)
            f32 = wn.fused_wavenet_stack(x, c, plain_w, dil)
            torch.cuda.synchronize()
            same = all(torch.equal(g, a) and torch.equal(g, f)
                       for g, a, f in zip(got, again, fresh))
            print(f"K3 bf16 determinism [{name}]: two runs, and a run that rounds its "
                  f"weights per call, bitwise equal = {same}")
            if not same:
                _fail(f"K3 bf16 gives different outputs in two runs ({name})")
            # each layer above: the kernel and the truncated control, a host
            # call and a launch each; each cycle: one host call of len(dil)
            counts = (wn.fused_wavenet_stack.bf16_calls - counts0[0],
                      wn.fused_wavenet_stack.bf16_launches - counts0[1])
            print(f"K3 bf16 [{name}]: {counts[0]} host calls, {counts[1]} launches")
            if counts != (2 * len(dil) + 3, 2 * len(dil) + 3 * len(dil)):
                _fail(f"K3 bf16 {name}: host calls and launches {counts}")
            print(f"K3 bf16 whole cycle vs plain [{name}]: x {_rms_max_equal(got[0], want[0])}, "
                  f"skip {_rms_max_equal(got[1], want[1])} (rms, max, share bit-equal, "
                  f"max|diff|; bounds: x bit-equal >= {K3_BF16_CYCLE_EQUAL}, skip rms <= "
                  f"{K3_BF16_CYCLE_SKIP_RMS}, max <= 1e-2); float32 kernel x "
                  f"{_rms_max_equal(f32[0], want[0])}, skip {_rms_max_equal(f32[1], want[1])}")
            if not _k3_bf16_cycle_ok(got, want) or _k3_bf16_cycle_ok(f32, want):
                _fail(f"K3 bf16 whole cycle ({name}): the kernel outside the chain's noise, "
                      "or the float32 kernel inside it")
            if name != "v1 cycle":
                continue
            wf = wn.with_fragments(plain_w)
            rec["ms"] = _median_ms(lambda: wn.fused_wavenet_stack(x, c, w, dil, bf16))
            rec["f32_ms"] = _median_ms(lambda: wn.fused_wavenet_stack(x, c, wf, dil))
            rec["plain_ms"] = _median_ms(
                lambda: wn.wavenet_stack_reference_bf16(x, c, plain_w, dil))
            flops = _wavenet_work(x, c, plain_w)["flops"]
            n_w = sum(plain_w[k].numel() for k in ("wconv", "waux", "wskip", "wres"))
            n_b = sum(plain_w[k].numel() for k in ("bconv", "bskip", "bres"))
            rows = b * t
            nbytes = rows * (2 * (2 * ch + ca) + 4 * ch) + 2 * n_w + 4 * n_b
            rec.update(_bf16_work(flops, nbytes))
            design = rows * (len(dil) * (2 * 2 * ch + 2 * ca + 4 * ch)
                             + (len(dil) - 1) * 4 * ch) + 2 * n_w + 4 * n_b
            print(f"time [K3 bf16, one v1 cycle of {len(dil)} layers, B={b} T={t}, median "
                  f"of 10, CUDA events]: kernel {rec['ms']:.3f} ms (bf16 weights kept, as "
                  f"decode), float32 K3 {rec['f32_ms']:.3f} ms, bf16 plain version "
                  f"{rec['plain_ms']:.3f} ms; bound {rec['bound_ms']:.3f} ms by "
                  f"{rec['bound_by']} ({flops / 1e9:.1f} GFLOP at 989 TFLOP/s, "
                  f"{nbytes / 1e6:.1f} MB of the cycle's inputs and outputs at 3.35 TB/s; "
                  f"{rec['bound_ms'] / rec['ms']:.1%} of it), the per-layer design's "
                  f"{design / 1e9:.2f} GB at 3.35 TB/s {design / PEAK_BYTES * 1e3:.3f} ms "
                  f"({design / PEAK_BYTES * 1e3 / rec['ms']:.1%}) on {card}")
        rec["errs"].append(_k3_bf16_past_int32(card))
    return rec


def _k3_bf16_past_int32(card: str) -> float:
    """One layer of K3's bf16 mode (d = 512) on (64, 557056, 64) with aux
    80, past 2**31 elements of x and c (``_past_int32``'s float32 case),
    bf16 inputs of gain one and random weights; rows 0 and 63 against the
    bf16 plain version on B = 1 slices by the layer rule. Returns the
    max|diff|."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn

    rs = np.random.RandomState(SEED + 38)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, t, ch, ca = 64, (2048 + 2 * 64) * 256, 64, 80

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    x = torch.randn((b, t, ch), generator=gen, device="cuda", dtype=torch.bfloat16)
    c = torch.randn((b, t, ca), generator=gen, device="cuda", dtype=torch.bfloat16)
    w = {"wconv": randn(1, 3, ch, 2 * ch, scale=(3 * ch) ** -0.5),
         "bconv": randn(1, 2 * ch, scale=0.1), "waux": randn(1, ca, 2 * ch, scale=ca ** -0.5),
         "wskip": randn(1, ch, ch, scale=ch ** -0.5), "bskip": randn(1, ch, scale=0.1),
         "wres": randn(1, ch, ch, scale=ch ** -0.5), "bres": randn(1, ch, scale=0.1)}
    with torch.inference_mode():
        got = wn.fused_wavenet_stack(x, c, w, (512,), torch.bfloat16)
        rows = [(g[0:1], g[b - 1:b]) for g in got]
        del got
        torch.cuda.synchronize()
        err = 0.0
        for i, r in enumerate((0, b - 1)):
            want = wn.wavenet_stack_reference_bf16(x[r:r + 1], c[r:r + 1], w, (512,))
            mine = (rows[0][i], rows[1][i])
            sx, ss = _rms_max_equal(mine[0], want[0]), _rms_max_equal(mine[1], want[1])
            err = max(err, sx[3], ss[3])
            if not _k3_bf16_layer_ok(mine, want):
                _fail(f"K3 bf16 past 2**31 elements: row {r} x {sx}, skip {ss}")
    print(f"K3 bf16 past 2**31 elements {(b, t, ch)} (aux {ca}), one layer at d=512: rows 0 "
          f"and {b - 1} against the plain version on B = 1 by the layer rule, max|diff| "
          f"{err:.3e} on {card}")
    del x, c
    torch.cuda.empty_cache()
    return err


def _k3_bf16_generator() -> dict:
    """PWG v1's generator params for K3's bf16 mode: the shipped ones without
    ``use_pallas_stack_train``, with ``use_pallas_stack`` and
    ``pallas_stack_bf16``."""
    gp = {k: v for k, v in V1_PWG_GENERATOR.items() if k != "use_pallas_stack_train"}
    return dict(gp, use_pallas_stack=True, pallas_stack_bf16=True)


def _wav_rms(dir_a: str, dir_b: str) -> tuple:
    """(rms|a - b| / rms|b|, max|a - b| / max|b|) over every utterance of
    two decodes (``_compare_wavs`` checks their set, lengths and values)."""
    import numpy as np

    _compare_wavs(dir_a, dir_b)
    wav_a, wav_b = _read_wavs(dir_a), _read_wavs(dir_b)
    a = np.concatenate([wav_a[k] for k in sorted(wav_a)])
    b = np.concatenate([wav_b[k] for k in sorted(wav_b)])
    return (float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean())),
            float(np.abs(a - b).max() / np.abs(b).max()))


def _residual_d_config(kernel: bool, **overrides) -> dict:
    """PWG v1's training config with ResidualParallelWaveGANDiscriminator at
    its defaults (30 layers, 64 / 128 / 64 channels) and D from step 2."""
    cfg = _pwg_v1_config(kernel, **overrides)
    cfg.update(discriminator_type="ResidualParallelWaveGANDiscriminator",
               discriminator_params={}, discriminator_train_start_steps=0)
    return cfg


def _residual_d_cross_check(card: str) -> float:
    """One G+D ``TrainStep`` of PWG v1 (``use_pallas_stack_train``: K3/K4 on
    the card, their plain versions on the CPU) with the residual
    discriminator at B=2 x 25600, on the card and on the CPU from the same
    weights and batch: every loss to 1e-4 relative."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import TrainStep

    cfg = _residual_d_config(True, batch_size=2)
    g = torch.Generator().manual_seed(SEED + 1)
    t = cfg["batch_max_steps"]
    frames = t // cfg["hop_size"] + 2 * cfg["generator_params"]["aux_context_window"]
    batch = {"y": 0.3 * torch.randn(2, 1, t, generator=g),
             "c": torch.randn(2, 80, frames, generator=g),
             "z": torch.randn(2, 1, t, generator=g)}
    got = {}
    for device in ("cuda", "cpu"):
        init = torch.Generator().manual_seed(SEED)  # the same weights on both
        gd = get_model_class(cfg["generator_type"])(
            **cfg["generator_params"], generator=init).to(device)
        dd = get_model_class(cfg["discriminator_type"])(
            **cfg["discriminator_params"], generator=init).to(device)
        step = TrainStep(cfg, gd, dd, build_criterion(cfg),
                         build_optimizer_from_config(cfg, "generator", gd.parameters()),
                         build_optimizer_from_config(cfg, "discriminator", dd.parameters()))
        t0 = time.perf_counter()
        got[device] = {k: float(v) for k, v in step(
            {k: v.to(device) for k, v in batch.items()}, True, True, 0).items()}
        print(f"PWG v1 + residual D G+D TrainStep at B=2 T={t} on {device}: "
              f"{time.perf_counter() - t0:.1f} s (first call, host clock)")
        del gd, dd, step
    if sorted(got["cuda"]) != sorted(got["cpu"]):
        _fail(f"residual D cross-check: metrics {sorted(got['cuda'])} vs {sorted(got['cpu'])}")
    worst = 0.0
    for key, want in got["cpu"].items():
        rel = abs(got["cuda"][key] - want) / max(abs(want), 1e-30)
        if not rel <= 1e-4:
            _fail(f"residual D cross-check: {key} = {got['cuda'][key]!r} on the card vs "
                  f"{want!r} on the CPU")
        worst = max(worst, rel)
    print(f"PWG v1 + residual D G+D step, card ({card}) vs CPU: max relative loss diff "
          f"{worst:.3e} over {sorted(got['cpu'])} (tol 1e-4)")
    return worst


def phase_pwg_family(card: str) -> dict:
    """PWG v1 decode in K3's bf16 mode and causal through K5, and PWG v1
    training with ResidualParallelWaveGANDiscriminator (module docstring,
    phase 31)."""
    import numpy as np
    import torch

    import parallelwavegan_tpu_torch.models.parallel_wavegan as pwg_mod
    from parallelwavegan_tpu_torch.bin import decode
    from parallelwavegan_tpu_torch.ops.kernels import wavenet as wn
    from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import wavenet_stack_backward

    gp = _k3_bf16_generator()
    causal = dict(gp, use_pallas_stack=False, pallas_stack_bf16=False, use_causal_conv=True)
    per_run = V1_PWG_GENERATOR["layers"] * len(UTT_FRAMES)

    def plain_bf16(x, c, weights, dilations, compute_dtype):
        if compute_dtype != torch.bfloat16:
            _fail("the bf16 decode asked for another compute type")
        return wn.wavenet_stack_reference_bf16(x, c, {k: weights[k] for k in wn.WEIGHT_KEYS},
                                               dilations)

    # run: (config, launches expected (K3, K3's bf16 mode, its host calls,
    # K5), the stack patched to its bf16 plain version); the same noise in
    # every run
    utts = len(UTT_FRAMES)
    runs = {"bf16": ("bf16", (per_run, per_run, utts, 0), False),
            "bf16_plain": ("bf16", (0, 0, 0, 0), True),
            "float32": ("float32", (per_run, 0, 0, 0), False),
            "causal_k5": ("causal_k5", (0, 0, 0, per_run), False),
            "causal_plain": ("causal_plain", (0, 0, 0, 0), False)}
    res = {}
    for name, (cfg, expect, patched) in runs.items():
        if name == "bf16":
            p = _write_inputs("ParallelWaveGANGenerator", gp,
                              {"bf16": {}, "float32": {"pallas_stack_bf16": False}})
        elif name == "causal_k5":  # the causal model's own checkpoint
            err, err_max = _wav_rms(os.path.join(p["root"], "wav_bf16"),
                                    os.path.join(p["root"], "wav_bf16_plain"))
            f32_rms, f32_max = _wav_rms(os.path.join(p["root"], "wav_float32"),
                                        os.path.join(p["root"], "wav_bf16_plain"))
            p = _write_inputs("ParallelWaveGANGenerator", causal,
                              {"causal_k5": {"use_pallas_kernels": True}, "causal_plain": {}})
        _reset_launch_counts()
        np.random.seed(SEED)
        real = pwg_mod.fused_wavenet_stack
        if patched:
            pwg_mod.fused_wavenet_stack = plain_bf16
        try:
            res[name] = decode.main(
                ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"], "--normalize-before",
                 "--device", "cuda", "--config", p[cfg], "--use-pallas-stack",
                 "--outdir", os.path.join(p["root"], f"wav_{name}")])
        finally:
            pwg_mod.fused_wavenet_stack = real
        got = (wn.fused_wavenet_stack.launches, wn.fused_wavenet_stack.bf16_launches,
               wn.fused_wavenet_stack.bf16_calls, wn.fused_gated_resblock.launches)
        print(f"main path [PWG v1 {name} decode]: K3 launches = {got[0]} (bf16 mode "
              f"{got[1]} in {got[2]} host calls), K5 launches = {got[3]} for "
              f"{len(UTT_FRAMES)} utterances")
        if got != expect:
            _fail(f"PWG {name} decode: launches {got}, expected {expect}")
        if name == "bf16":
            k3_bf16_launches = got[1]
    print(f"PWG v1 bf16 decode (K3 bf16, 16-bit WAVs) vs its bf16 plain version: rms|diff| "
          f"{err:.3e} of rms|plain| (bound {K3_BF16_DECODE_RMS}), max {err_max:.3e} of "
          f"max|plain|; the float32 stack decode vs the bf16 plain one: {f32_rms:.3e} rms, "
          f"{f32_max:.3e} max")
    if not err <= K3_BF16_DECODE_RMS:
        _fail("PWG v1 bf16 decode outside the bf16 chain's noise of its plain version")
    causal_err = _compare_wavs(os.path.join(p["root"], "wav_causal_k5"),
                               os.path.join(p["root"], "wav_causal_plain"))
    print(f"causal PWG v1 decode, K5 vs plain: max|diff| = {causal_err:.3e} (tol {TOL})")
    if not causal_err <= TOL:
        _fail("causal PWG v1 decode through K5 disagrees with the plain decode")
    print(f"PWG v1 decode RTF (mean of {len(UTT_FRAMES)} utterances, first one includes "
          f"warm-up) on {card}: " + ", ".join(f"{k} {_rtfs(v)}" for k, v in res.items()))
    shutil.rmtree(p["root"])

    steps = TRAIN_OVERRIDES["train_max_steps"]
    layers = V1_PWG_GENERATOR["layers"]
    per_call = 5  # pallas_stack_train_layers_per_call's default
    expect = {"plain": (0, 0)}
    for name, n, d_steps in (("kernel", steps, steps - 1), ("resume", steps - 2, 2)):
        # no-grad G forwards: the D phase's re-run at steps 2-4 (of them the
        # resumed run's 3-4) and the eval at step 4 (its batch, its predictions)
        k3 = n * (layers + layers // per_call * (per_call - 1)) + (d_steps + 2) * layers
        expect[name] = (k3, n * layers)
    out = _train_runs(card, "PWG v1 + residual D", _residual_d_config,
                      {"K3": lambda: wn.fused_wavenet_stack.launches,
                       "K4": lambda: wavenet_stack_backward.launches},
                      expect, lambda: wn.fused_wavenet_stack.launches, TRAIN_UTTS * layers)
    cross = _residual_d_cross_check(card)
    return {"k3_bf16_launches": k3_bf16_launches, "decode_rms": err,
            "causal_err": causal_err, "train_err": out["err"], "cross": cross}


# phase 34: the recipe at LJSpeech's shapes. 44 utterances of 1.5-6 s at
# 22.05 kHz, split train / dev / eval; the loader drops incomplete batches,
# so train and dev each need HiFi-GAN v1's batch of 16; 8 of the train
# utterances are cut by a segments file from one long recording
RECIPE_SPLITS = {"train": 20, "dev": 16, "eval": 8}
RECIPE_SEGMENTED = 8
RECIPE_SECONDS = (1.5, 6.0)
RECIPE_BATCH = 4  # decode's --batch-size


def _recipe_corpus(root: str) -> dict:
    """The phase's WAVs (16-bit, the port's ``write_wav``): harmonics of a
    random f0 under AM, plus noise; a wav.scp per split and the train
    split's segments file. Returns {split: wav.scp} and "segments"."""
    import numpy as np

    from parallelwavegan_tpu_torch.utils.io import write_wav

    fs = V1_FEATURES["sampling_rate"]
    rs = np.random.RandomState(SEED)
    wavdir = os.path.join(root, "wav")
    os.makedirs(wavdir)

    def utterance():
        t = np.arange(int(rs.uniform(*RECIPE_SECONDS) * fs)) / fs
        f0 = rs.uniform(80.0, 260.0)
        x = sum(np.sin(2 * np.pi * k * f0 * t + rs.uniform(0, 2 * np.pi)) / k
                for k in range(1, 6))
        am = 1.0 + 0.6 * np.sin(2 * np.pi * rs.uniform(0.5, 4.0) * t)
        return (0.15 * x * am + 0.01 * rs.randn(len(t))).clip(-0.99, 0.99)

    paths, segments = {}, []
    for split, n in RECIPE_SPLITS.items():
        lines = []
        if split == "train":
            pieces = [utterance() for _ in range(RECIPE_SEGMENTED)]
            write_wav(os.path.join(wavdir, "long.wav"), fs, np.concatenate(pieces))
            lines.append(f"long {wavdir}/long.wav\n")
            start = 0
            for i, p in enumerate(pieces):
                # start and end on the 16-bit WAV's sample grid, in seconds
                segments.append(f"train{i:02d} long {start / fs:.6f} "
                                f"{(start + len(p)) / fs:.6f}\n")
                start += len(p)
        for i in range(RECIPE_SEGMENTED if split == "train" else 0, n):
            utt = f"{split}{i:02d}"
            write_wav(os.path.join(wavdir, f"{utt}.wav"), fs, utterance())
            lines.append(f"{utt} {wavdir}/{utt}.wav\n")
            if split == "train":
                segments.append(f"{utt} {utt} 0.0 -1\n")
        paths[split] = os.path.join(root, f"{split}_wav.scp")
        with open(paths[split], "w") as f:
            f.writelines(lines)
    paths["segments"] = os.path.join(root, "train_segments")
    with open(paths["segments"], "w") as f:
        f.writelines(segments)
    return paths


def _batched_kernel_decode(card: str, gen_type: str, generator_params: dict,
                           variants: dict, counter, expect: int) -> dict:
    """``bin/decode.main --feats-scp --batch-size 4`` of a random-init, full
    width checkpoint on UTT_FRAMES and a fourth mel of 512 frames (one
    batch), with the kernel config and the plain one, the same noise: the
    kernel launches ``expect`` times and the WAVs agree to TOL."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import decode

    p = _write_inputs(gen_type, generator_params, variants)
    rs = np.random.RandomState(SEED + 4)
    fourth = np.load(os.path.join(p["dump"], "utt0-feats.npy"))
    np.save(os.path.join(p["dump"], "utt3-feats.npy"),
            (fourth + 0.1 * rs.randn(*fourth.shape)).astype(np.float32))
    frames = UTT_FRAMES + (UTT_FRAMES[0],)
    scp = os.path.join(p["root"], "feats.scp")
    with open(scp, "w") as f:
        f.writelines(f"utt{i}-feats {p['dump']}/utt{i}-feats.npy\n"
                     for i in range(len(frames)))
    launches, res = {}, {}
    for name in ("kernel", "plain"):
        _reset_launch_counts()
        np.random.seed(SEED)  # the same noise in both runs
        res[name] = decode.main(
            ["--feats-scp", scp, "--batch-size", str(RECIPE_BATCH), "--checkpoint",
             p["ckpt"], "--normalize-before", "--device", "cuda", "--verbose", "0",
             "--config", p[name], "--outdir", os.path.join(p["root"], f"wav_{name}")])
        launches[name] = counter()
    err = _compare_wavs(os.path.join(p["root"], "wav_kernel"),
                        os.path.join(p["root"], "wav_plain"), frames)
    print(f"main path [{gen_type} batched decode, B={RECIPE_BATCH}, frames {frames}]: "
          f"kernel launches {launches['kernel']} (plain run {launches['plain']}); "
          f"kernel vs plain max|diff| = {err:.3e} (tol {TOL}, 16-bit WAVs); RTF of the "
          f"batch (first call, warm-up included) kernel {res['kernel']['rtf']:.6f}, "
          f"plain {res['plain']['rtf']:.6f} on {card}")
    if launches != {"kernel": expect, "plain": 0}:
        _fail(f"{gen_type} batched decode: launches {launches}, expected {expect} and 0")
    if not err <= TOL:
        _fail(f"{gen_type} batched decode through its kernel disagrees with the plain one")
    shutil.rmtree(p["root"])
    return {"launches": launches["kernel"], "err": err}


def phase_recipe(card: str) -> dict:
    """The recipe at LJSpeech's shapes (module docstring, phase 34):
    preprocess, compute_statistics and normalize through the port's CLIs,
    4 HiFi-GAN v1 steps through scp files, decode from a Kaldi ark in
    batches of 4 through K1 and without it; K3 and K6 in batched decode."""
    import numpy as np
    import torch

    import parallelwavegan_tpu_torch.models.hifigan as hifigan_mod
    from parallelwavegan_tpu_torch.bin import (
        compute_statistics,
        decode,
        normalize,
        preprocess,
        train,
    )
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        hifigan_tail_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import fused_melgan_stacks
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import fused_wavenet_stack
    from parallelwavegan_tpu_torch.utils.kaldi_ark import write_ark

    root = os.path.join(WORK, "recipe")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    seconds = {}

    def stage(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    wav = stage("write the corpus", _recipe_corpus, root)
    config = os.path.join(root, "config.json")
    with open(config, "w") as f:  # hifigan.v1.yaml as it ships, but npy dumps
        json.dump(_hifigan_v1_config(**HIFIGAN_TRAIN_OVERRIDES), f)
    common = ["--config", config, "--verbose", "0"]

    def dump(split, kind):
        return os.path.join(root, "dump", split, kind)

    def run_preprocess():
        for split in RECIPE_SPLITS:
            preprocess.main(common + ["--wav-scp", wav[split], "--dumpdir", dump(split, "raw")]
                            + (["--segments", wav["segments"]] if split == "train" else []))

    def run_normalize():
        for split in RECIPE_SPLITS:
            normalize.main(common + ["--rootdir", dump(split, "raw"), "--dumpdir",
                                     dump(split, "norm"), "--stats",
                                     os.path.join(root, "stats.npy")])

    stage("preprocess", run_preprocess)
    stage("compute_statistics", compute_statistics.main,
          common + ["--rootdir", dump("train", "raw"), "--dumpdir", root])
    stage("normalize", run_normalize)
    mels = {}
    for split, n in RECIPE_SPLITS.items():
        names = sorted(os.listdir(dump(split, "norm")))
        feats = [x for x in names if x.endswith("-feats.npy")]
        if len(feats) != n or len(names) != 2 * n:
            _fail(f"recipe: {split} normalized dump holds {names}")
        with open(os.path.join(root, f"{split}_feats.scp"), "w") as f:
            for name in feats:  # npy dumps name an utterance after its wave file
                utt = name.split("-")[0]
                mels[utt] = np.load(os.path.join(dump(split, "norm"), name))
                f.write(f"{utt} {dump(split, 'norm')}/{name}\n")
    stats = np.load(os.path.join(root, "stats.npy"))
    allm = np.concatenate([mels[u] for u in mels if u.startswith("train")])
    if stats.shape != (2, 80) or not np.isfinite(allm).all() or not (
            abs(allm.mean(0)).max() < 1e-3 and abs(allm.std(0) - 1).max() < 1e-3):
        _fail("recipe: the normalized train features are not of zero mean and unit scale")

    res = stage("train (4 steps)", train.main, [
        "--train-wav-scp", wav["train"], "--train-segments", wav["segments"],
        "--train-feats-scp", os.path.join(root, "train_feats.scp"),
        "--dev-wav-scp", wav["dev"], "--dev-feats-scp", os.path.join(root, "dev_feats.scp"),
        "--outdir", os.path.join(root, "exp"), "--device", "cuda", "--verbose", "0",
        "--config", config])
    steps = HIFIGAN_TRAIN_OVERRIDES["train_max_steps"]
    logged = {s: m for s, m in res["history"] if any(k.startswith("train/") for k in m)}
    for s in range(1, steps + 1):
        m = {k: v for k, v in logged.get(s, {}).items() if k.startswith("train/")}
        print(f"  recipe step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
        if not m or not all(np.isfinite(v) for v in m.values()):
            _fail(f"recipe training: step {s} logged {m}")
    if res["steps"] != steps or not any("eval/mel_loss" in m for _, m in res["history"]):
        _fail(f"recipe training: {res['steps']} steps, eval logged: "
              f"{any('eval/mel_loss' in m for _, m in res['history'])}")

    ark, scp = os.path.join(root, "eval.ark"), os.path.join(root, "eval.scp")
    evals = sorted(u for u in mels if u.startswith("eval"))
    stage("write the eval ark", write_ark, ark, {u: mels[u] for u in evals}, scp)
    ckpt = os.path.join(root, "exp", f"checkpoint-{steps}steps.pkl")
    calls, wavs, run = [], {"tail": {}, "plain": {}}, {}
    real_tail, real_write = hifigan_mod.fused_hifigan_tail, decode.write_wav

    def keep(x, *args, **kwargs):  # the tail's inputs, for the timing below
        calls.append((x.clone(), args, kwargs))
        return real_tail(x, *args, **kwargs)

    def write(path, fs, y):  # each waveform before the 16-bit rounding
        wavs[run["name"]][os.path.basename(path)] = y.copy()
        real_write(path, fs, y)

    hifigan_mod.fused_hifigan_tail, decode.write_wav = keep, write
    try:
        for name, flags in (("tail", ["--use-pallas-tail"]), ("plain", [])):
            run["name"] = name
            _reset_launch_counts()
            out = stage(f"decode ({name}, B={RECIPE_BATCH})", decode.main, [
                "--feats-scp", scp, "--batch-size", str(RECIPE_BATCH), "--checkpoint",
                ckpt, "--device", "cuda", "--verbose", "0",
                "--outdir", os.path.join(root, f"wav_{name}")] + flags)
            n = fused_hifigan_tail.launches
            want = -(-len(evals) // RECIPE_BATCH) if name == "tail" else 0
            print(f"main path [recipe decode from the Kaldi ark, {name}, "
                  f"--batch-size {RECIPE_BATCH}]: K1 launches = {n} for {len(evals)} "
                  f"utterances; RTF per batch {['%.6f' % r for r in out['rtfs']]}")
            if n != want:
                _fail(f"recipe decode [{name}]: {n} K1 launches, expected {want}")
            if name == "tail":
                k1_launches = n
    finally:
        hifigan_mod.fused_hifigan_tail, decode.write_wav = real_tail, real_write
    if sorted(wavs["tail"]) != sorted(wavs["plain"]) or len(wavs["tail"]) != len(evals):
        _fail(f"recipe decode: {sorted(wavs['tail'])} vs {sorted(wavs['plain'])}")
    err = ratio = 0.0
    hop = V1_FEATURES["hop_size"]
    for k, want in wavs["plain"].items():
        got = wavs["tail"][k]
        utt = k[: -len("_gen.wav")]
        if got.shape != want.shape or want.shape != (mels[utt].shape[0] * hop,) or not (
                np.isfinite(got).all() and np.abs(want).max() > 0):
            _fail(f"recipe decode: {k} shapes {got.shape} / {want.shape}")
        e = float(np.abs(got - want).max())
        err, ratio = max(err, e), max(ratio, e / float(np.abs(want).max()))
    print(f"recipe decode, K1 at B={RECIPE_BATCH} vs plain (float, before the 16-bit "
          f"rounding): max|diff| = {err:.3e} (tol {TOL}), {ratio:.2e} of max|plain| "
          f"(tol 1e-4) over {len(evals)} utterances")
    if not (err <= TOL and ratio <= 1e-4):
        _fail("recipe decode: K1 at B=4 disagrees with the plain decode")

    # K1 per B=4 batch on the decode's own tail inputs and weights
    k1 = {"errs": [], "ms": [], "plain_ms": [], "bound_ms": []}
    with torch.inference_mode():
        for x, args, kwargs in calls[: k1_launches]:
            stages, final_w, final_b = args
            got = real_tail(x, *args, **kwargs)
            ref = hifigan_tail_reference(x, stages, final_w, final_b, **kwargs)
            e, r, ok = _within(got, ref)
            if not ok or x.shape[0] != RECIPE_BATCH:
                _fail(f"K1 at {tuple(x.shape)}: max|diff| {e:.3e}, {r:.2e} of max|plain|")
            rec = _tail_work(x, {"stages": stages, "final_w": final_w, "final_b": final_b,
                                 "pre_blocks": kwargs.get("pre_blocks")})
            fp32_ms = _split_tf32_bound(rec)
            ms = _median_ms(lambda: real_tail(x, *args, **kwargs))
            plain_ms = _median_ms(lambda: hifigan_tail_reference(
                x, stages, final_w, final_b, **kwargs))
            print(f"time [K1, recipe decode batch (B, T0, C0) = {tuple(x.shape)}, median of "
                  f"10, CUDA events]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{rec['bound_ms']:.3f} ms at the split-TF32 rate (3 x "
                  f"{rec['flops'] / 1e9:.1f} GFLOP / 495 TFLOP/s; {rec['bound_ms'] / ms:.1%} "
                  f"of it), {fp32_ms:.3f} ms at the float32 rate; max|diff| {e:.3e} "
                  f"({r:.2e} of max|plain|) on {card}")
            for key, v in (("errs", e), ("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", rec["bound_ms"])):
                k1[key].append(v)
    shutil.rmtree(root)

    def k3_count():
        return fused_wavenet_stack.launches

    def k6_count():
        return fused_melgan_stacks.launches

    t0 = time.perf_counter()
    # one batch of 4: the 30 layers once (K3), the 8 stacks and final conv once (K6)
    k3 = _batched_kernel_decode(card, "ParallelWaveGANGenerator", V1_PWG_GENERATOR,
                                {"kernel": {}, "plain": {"use_pallas_stack_train": False}},
                                k3_count, V1_PWG_GENERATOR["layers"])
    k6 = _batched_kernel_decode(card, "MelGANGenerator", V2_MB_GENERATOR,
                                {"kernel": {"use_pallas_stacks": True}, "plain": {}},
                                k6_count, 9)
    seconds["PWG v1 and MB-MelGAN v2 batched decodes"] = time.perf_counter() - t0
    print(f"recipe host time by stage on {card}: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return {"k1_launches": k1_launches, "err": err, "k1": k1,
            "k3_launches": k3["launches"], "k6_launches": k6["launches"]}


# phase 35: the discrete-symbol (HuBERT-unit) vocoders. The features of
# the hubert recipes: unit ids (and a speaker id) for the mel, at 16 kHz
# with hop 320
HUBERT_FEATURES = dict(sampling_rate=16000, fft_size=None, hop_size=320,
                       win_length=None, window=None, num_mels=2, fmin=None,
                       fmax=None, global_gain_scale=1.0, trim_silence=False,
                       trim_threshold_in_db=20, trim_frame_size=1024,
                       trim_hop_size=256, format="hdf5")
HUBERT_TRAINING = dict(
    batch_size=16, batch_max_steps=10240, pin_memory=True, num_workers=2,
    remove_short_samples=False, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=2.0e-4, betas=[0.5, 0.9], weight_decay=0.0),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5,
                                    milestones=[200000, 400000, 600000, 800000]),
    generator_grad_norm=-1, discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=2.0e-4, betas=[0.5, 0.9], weight_decay=0.0),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5,
                                        milestones=[200000, 400000, 600000, 800000]),
    discriminator_grad_norm=-1, generator_train_start_steps=1,
    discriminator_train_start_steps=0, train_max_steps=2500000,
    save_interval_steps=50000, eval_interval_steps=1000, log_interval_steps=100,
    num_save_intermediate_results=4,
)
# the HiFi-GAN trunk of the hubert generators (scales 10, 8, 2, 2: 320
# samples an id)
HUBERT_TRUNK = dict(
    in_channels=512, out_channels=1, channels=512, kernel_size=7,
    upsample_scales=[10, 8, 2, 2], upsample_kernel_sizes=[20, 16, 4, 4],
    resblock_kernel_sizes=[3, 7, 11],
    resblock_dilations=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    use_additional_convs=True, bias=True, nonlinear_activation="LeakyReLU",
    nonlinear_activation_params={"negative_slope": 0.1}, use_weight_norm=True,
)
# the whole of egs/vctk/hubert_voc1/conf/hifigan_hubert.v1.yaml (a test
# holds it equal to the file): 100 units, 128 speakers added at width 512
HUBERT_HIFIGAN_CONFIG = dict(
    HUBERT_FEATURES, generator_type="DiscreteSymbolHiFiGANGenerator",
    generator_params=dict(HUBERT_TRUNK, num_embs=100, num_spk_embs=128,
                          spk_emb_dim=512, concat_spk_emb=False),
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=V1_HIFIGAN_CONFIG["discriminator_params"],
    use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=1024, hop_size=256, win_length=None,
                         window="hann", num_mels=80, fmin=0, fmax=8000, log_base=None),
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    use_feat_match_loss=True,
    feat_match_loss_params=dict(average_by_discriminators=False,
                                average_by_layers=False, include_final_outputs=True),
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0, **HUBERT_TRAINING,
)
# the whole of egs/cvss_c/hubert_voc1/conf/hifigan_hubert_duration.v1.yaml
# (a test holds it equal to the file): 500 units, no speaker, the duration
# predictor and its loss
HUBERT_DURATION_CONFIG = dict(
    HUBERT_HIFIGAN_CONFIG, num_mels=1, generator_type="DiscreteSymbolDurationGenerator",
    generator_params=dict(HUBERT_TRUNK, num_embs=500, duration_layers=2,
                          duration_chans=384, duration_kernel_size=3,
                          duration_offset=1.0, duration_dropout_rate=0.5,
                          num_spk_embs=0),
    use_duration_loss=True, duration_loss_params=dict(offset=1.0, reduction="mean"),
    num_workers=0,
)
# the whole of egs/vctk/hubert_voc1/conf/style_melgan_hubert.v1.yaml (a test
# holds it equal to the file): noise x56, blocks 5, 2 x 6, 1, 1 (320 samples
# an id), block 0's aux width 128
HUBERT_STYLE_CONFIG = dict(
    HUBERT_FEATURES, num_mels=1, trim_threshold_in_db=60,
    generator_type="DiscreteSymbolStyleMelGANGenerator",
    generator_params=dict(
        in_channels=128, aux_channels=128, channels=64, out_channels=1,
        num_embs=100, num_spk_embs=128, spk_emb_dim=128, concat_spk_emb=False,
        kernel_size=9, dilation=2, bias=True, noise_upsample_scales=[7, 2, 2, 2],
        noise_upsample_activation="LeakyReLU",
        noise_upsample_activation_params={"negative_slope": 0.2},
        upsample_scales=[5, 2, 2, 2, 2, 2, 2, 1, 1], upsample_mode="nearest",
        gated_function="softmax", use_weight_norm=True),
    discriminator_type="StyleMelGANDiscriminator",
    discriminator_params=V1_STYLE_CONFIG["discriminator_params"],
    stft_loss_params=V1_STYLE_CONFIG["stft_loss_params"], lambda_aux=1.0,
    lambda_adv=1.0, generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    **{k: v for k, v in dict(
        HUBERT_TRAINING, batch_max_steps=17920,
        generator_optimizer_params=dict(lr=1.0e-4, betas=[0.5, 0.9], weight_decay=0.0),
        generator_scheduler_params=dict(
            gamma=0.5, milestones=[100000, 300000, 500000, 700000, 900000]),
        discriminator_train_start_steps=100000,
        train_max_steps=1500000).items() if k != "generator_train_start_steps"},
)


# phase 35's decodes: 3 utterances of these many ids (each with a speaker
# id), and the duration model's given durations expanded to 512 frames
HUBERT_UTTS = (512, 300, 77)
HUBERT_DURATION_IDS = 200
HUBERT_FRAMES = 512
# phase 35's training: the loader drops incomplete batches, so a batch of
# 16 needs 16 utterances; 4 steps, D from step 3 for StyleMelGAN (its own
# 100000), the duration model with its own start steps (G only, D only,
# G+D, G+D)
HUBERT_TRAIN_UTTS = 16
HUBERT_TRAIN_OVERRIDES = dict(TRAIN_OVERRIDES, discriminator_train_start_steps=1)


def _hubert_config(base: dict, **generator_params) -> dict:
    """A fresh copy of a hubert config with npy dumps and ``generator_params``
    laid over its own."""
    cfg = json.loads(json.dumps(base))
    cfg["format"] = "npy"
    cfg["generator_params"].update(generator_params)
    return cfg


def _token_dump(root: str, lengths, speakers: bool, hop: int = 0, seed: int = SEED) -> str:
    """An npy dump of unit-id utterances (runs of 1-4 equal ids of 100,
    channel 1 a speaker id of 128 where ``speakers``); with ``hop`` also
    their waves (harmonics of a random f0 plus noise at 16 kHz)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i, n in enumerate(lengths):
        units = np.repeat(rs.randint(0, 100, n), rs.randint(1, 5, n))[:n]
        feats = units[:, None].astype(np.float32)
        if speakers:
            feats = np.concatenate([feats, np.full_like(feats, rs.randint(128))], axis=1)
        np.save(os.path.join(root, f"utt{i}-feats.npy"), feats)
        if hop:
            t = np.arange(n * hop) / 16000.0
            audio = (0.3 * np.sin(2 * np.pi * rs.uniform(90, 250) * t)
                     + 0.05 * rs.randn(n * hop)).astype(np.float32)
            np.save(os.path.join(root, f"utt{i}-wave.npy"), audio)
    return root


def _hubert_checkpoint(root: str, config: dict, variants: dict) -> dict:
    """A random-init checkpoint of ``config``'s generator from SEED under
    root/exp and one JSON config per variant (generator_params overrides)."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.utils.checkpoint import save_checkpoint

    exp = os.path.join(root, "exp")
    os.makedirs(exp)
    gen = get_model_class(config["generator_type"])(
        **config["generator_params"], generator=torch.Generator().manual_seed(SEED))
    paths = {"ckpt": os.path.join(exp, "checkpoint-0steps.pkl")}
    save_checkpoint(paths["ckpt"], gen.state_dict(), steps=0)
    for name, overrides in variants.items():
        paths[name] = os.path.join(exp, f"config_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(_hubert_config(config, **overrides), f)
    return paths


def _decode_floats(args: list) -> tuple:
    """``bin/decode.main(args)`` and each waveform it wrote, before the
    16-bit rounding."""
    from parallelwavegan_tpu_torch.bin import decode

    wavs, real = {}, decode.write_wav

    def write(path, fs, y):
        wavs[os.path.basename(path)] = y.copy()
        real(path, fs, y)

    decode.write_wav = write
    try:
        res = decode.main(args + ["--verbose", "0"])
    finally:
        decode.write_wav = real
    return res, wavs


def _floats_agree(label: str, got: dict, want: dict, lengths: dict | None = None,
                  relative: bool = True, versus: str = "kernel vs plain") -> float:
    """max|got - want| over the utterances (of ``lengths`` samples, by
    default want's); fails on a wrong set or length, a non-finite or silent
    output, or a difference above 2e-4 or (with ``relative``) 1e-4 of
    max|want|."""
    import numpy as np

    lengths = lengths or {k: len(v) for k, v in want.items()}
    if sorted(got) != sorted(want) or sorted(want) != sorted(lengths):
        _fail(f"{label}: waveforms {sorted(got)} / {sorted(want)}")
    err = ratio = 0.0
    for k, n in lengths.items():
        a, b = got[k], want[k]
        if a.shape != (n,) or b.shape != (n,) or not np.isfinite(a).all() or not (
                np.abs(b).max() > 0):
            _fail(f"{label}: {k} shapes {a.shape} / {b.shape}, expected {n}")
        e = float(np.abs(a - b).max())
        err, ratio = max(err, e), max(ratio, e / float(np.abs(b).max()))
    print(f"{label}, {versus} (float, before the 16-bit rounding): max|diff| = "
          f"{err:.3e} (tol {TOL}), {ratio:.2e} of max|{'plain' if versus.endswith('plain') else 'reference'}|"
          + (" (tol 1e-4)" if relative else ""))
    if not (err <= TOL and (ratio <= 1e-4 or not relative)):
        _fail(f"{label}: {versus} disagree")
    return err


def _hubert_train(card: str, label: str, config_of, counters: dict, expect: dict,
                  frames) -> dict:
    """``bin/train.main`` for 4 steps from SEED at full width on
    HUBERT_TRAIN_UTTS token utterances of ``frames`` frames with their
    waves, for each variant of ``expect`` (name -> launches read by
    ``counters``); the variants' logged losses agree to 1e-4 relative.
    Returns {name: {step: {loss: value}}}."""
    import numpy as np

    from parallelwavegan_tpu_torch.bin import train

    root = os.path.join(WORK, "hubert_train")
    shutil.rmtree(root, ignore_errors=True)
    cfg0 = config_of(False)
    speakers = cfg0["generator_params"].get("num_spk_embs", 0) > 0
    hop = cfg0["hop_size"]
    lengths = [frames[0] + (frames[1] - frames[0]) * i // (HUBERT_TRAIN_UTTS - 1)
               for i in range(HUBERT_TRAIN_UTTS)]
    dump = _token_dump(os.path.join(root, "dump"), lengths, speakers, hop)
    steps = cfg0["train_max_steps"]
    logged = {}
    for name, want in expect.items():
        config = os.path.join(root, f"config_{name}.json")
        with open(config, "w") as f:
            json.dump(config_of(name == "kernel"), f)
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = train.main(["--train-dumpdir", dump, "--dev-dumpdir", dump, "--outdir",
                          os.path.join(root, f"exp_{name}"), "--device", "cuda",
                          "--verbose", "0", "--config", config])
        seconds = time.perf_counter() - t0
        got = tuple(count() for count in counters.values())
        print(f"main path [{label} training, {name}]: {res['steps']} steps in "
              f"{seconds:.1f} s (set-up, eval and saves included) on {card}; "
              + ", ".join(f"{k} launches = {n}" for k, n in zip(counters, got)))
        if res["steps"] != steps or got != want:
            _fail(f"{label} training {name}: steps {res['steps']}, launches {got}, "
                  f"expected {steps} and {want}")
        logged[name] = {}
        for s, m in res["history"]:
            logged[name].setdefault(s, {}).update(
                {k: v for k, v in m.items() if k.startswith("train/")})
        for s in range(1, steps + 1):
            m = logged[name].get(s, {})
            print(f"  {name} step {s}: "
                  + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
            if not m or not all(np.isfinite(v) for v in m.values()):
                _fail(f"{label} training {name}: step {s} logged {m}")
        if "train/discriminator_loss" not in logged[name][steps]:
            _fail(f"{label} training {name}: the D phase did not run")
        if not any("eval/generator_loss" in m for _, m in res["history"]):
            _fail(f"{label} training {name}: no evaluation was logged")
    if set(logged) == {"kernel", "plain"}:
        err = _losses_agree(f"{label} kernel vs plain", logged["kernel"], logged["plain"],
                            range(1, steps + 1))
        print(f"{label} training losses, kernel vs plain: max relative diff = {err:.3e} "
              f"over steps 1-{steps} (tol 1e-4)")
    shutil.rmtree(root)
    return logged


def phase_hubert(card: str) -> dict:
    """The discrete-symbol (HuBERT-unit) vocoders at the widths of their
    shipped configs (module docstring, phase 35): decode through K1 and
    K8, the duration model's given and predicted durations, StyleMelGAN
    training through K8/K9 and the duration model's training."""
    import numpy as np
    import torch

    import parallelwavegan_tpu_torch.models.hifigan as hifigan_mod
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        hifigan_tail_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.tade_decode import fused_tade_blocks
    from parallelwavegan_tpu_torch.ops.kernels.tade_train import tade_block_backward
    from parallelwavegan_tpu_torch.utils.model import load_model

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "hubert")
    shutil.rmtree(root, ignore_errors=True)
    out = {"k1": {"errs": []}}
    up = 320  # samples an id in every hubert config
    lengths = {f"utt{i}-feats_gen.wav": n * up for i, n in enumerate(HUBERT_UTTS)}

    # 1. HiFi-GAN: 3 utterances with speakers through bin/decode, K1 and plain
    hifi = os.path.join(root, "hifigan")
    dump = _token_dump(os.path.join(hifi, "dump"), HUBERT_UTTS, speakers=True)
    p = _hubert_checkpoint(hifi, HUBERT_HIFIGAN_CONFIG,
                           {"tail": {}, "plain": {"use_pallas_tail": False}})
    calls, real_tail = [], hifigan_mod.fused_hifigan_tail

    def keep(x, *args, **kwargs):  # the tail's inputs, for the timing below
        calls.append((x.clone(), args, kwargs))
        return real_tail(x, *args, **kwargs)

    wavs, k1 = {}, {}
    hifigan_mod.fused_hifigan_tail = keep
    try:
        for name, flags in (("tail", ["--use-pallas-tail"]), ("plain", [])):
            _reset_launch_counts()
            res, wavs[name] = _decode_floats(
                ["--dumpdir", dump, "--checkpoint", p["ckpt"], "--config", p[name],
                 "--device", "cuda", "--outdir", os.path.join(hifi, f"wav_{name}")] + flags)
            k1[name] = fused_hifigan_tail.launches
            print(f"main path [hubert HiFi-GAN decode, {name}]: K1 launches = {k1[name]} "
                  f"for {len(HUBERT_UTTS)} utterances of {HUBERT_UTTS} ids; RTF "
                  f"{_rtfs(res)} on {card}")
    finally:
        hifigan_mod.fused_hifigan_tail = real_tail
    if k1 != {"tail": len(HUBERT_UTTS), "plain": 0}:
        _fail(f"hubert HiFi-GAN decode: K1 launches {k1}, expected {len(HUBERT_UTTS)} and 0")
    out["k1"]["errs"].append(_floats_agree("hubert HiFi-GAN decode", wavs["tail"],
                                           wavs["plain"], lengths))
    out["k1_launches"] = k1["tail"]

    # K1 alone at the 512-id utterance's tail: (1, 40960, 128)
    x, args, kwargs = calls[0]
    if tuple(x.shape) != (1, HUBERT_UTTS[0] * 80, 128):
        _fail(f"hubert HiFi-GAN: K1's first input {tuple(x.shape)}")
    stages, final_w, final_b = args
    with torch.inference_mode():
        got = real_tail(x, *args, **kwargs)
        ref = hifigan_tail_reference(x, stages, final_w, final_b, **kwargs)
        e, r, ok = _within(got, ref)
        if not ok:
            _fail(f"K1 at {tuple(x.shape)}: max|diff| {e:.3e}, {r:.2e} of max|plain|")
        rec = _tail_work(x, {"stages": stages, "final_w": final_w, "final_b": final_b,
                             "pre_blocks": kwargs.get("pre_blocks")})
        fp32_ms = _split_tf32_bound(rec)
        ms = _median_ms(lambda: real_tail(x, *args, **kwargs))
        plain_ms = _median_ms(lambda: hifigan_tail_reference(
            x, stages, final_w, final_b, **kwargs))
    out["k1"]["errs"].append(e)
    out["k1"].update(ms=ms, plain_ms=plain_ms, bound_ms=rec["bound_ms"])
    print(f"time [K1, hubert HiFi-GAN tail (B, T0, C0) = {tuple(x.shape)}, median of 10, "
          f"CUDA events]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{rec['bound_ms']:.3f} ms at the split-TF32 rate (3 x {rec['flops'] / 1e9:.1f} "
          f"GFLOP / 495 TFLOP/s; {rec['bound_ms'] / ms:.1%} of it), {fp32_ms:.3f} ms at "
          f"the float32 rate; max|diff| {e:.3e} ({r:.2e} of max|plain|) on {card}")
    del calls, x, args, kwargs, got, ref

    # 2. the duration model: given durations (512 frames) through
    # InferenceModel.inference(ds=...), K1 and plain; then its predictor
    # through bin/decode
    dur = os.path.join(root, "duration")
    ddump = _token_dump(os.path.join(dur, "dump"), (HUBERT_DURATION_IDS,), speakers=False)
    p = _hubert_checkpoint(dur, HUBERT_DURATION_CONFIG,
                           {"tail": {"use_pallas_tail": True}, "plain": {}})
    ids = np.load(os.path.join(ddump, "utt0-feats.npy"))
    rs = np.random.RandomState(SEED + 5)
    ds = rs.multinomial(HUBERT_FRAMES - len(ids), np.full(len(ids), 1.0 / len(ids))) + 1
    ys = {}
    for name in ("tail", "plain"):
        with open(p[name]) as f:
            model = load_model(p["ckpt"], json.load(f), device="cuda")
        _reset_launch_counts()
        ys[name] = model.inference(ids, ds=ds)[:, 0]
        k1[name] = fused_hifigan_tail.launches
        del model
    print(f"main path [hubert duration decode, given durations ({len(ids)} ids, "
          f"{int(ds.sum())} frames)]: K1 launches = {k1['tail']} (plain run {k1['plain']})")
    if (k1["tail"], k1["plain"]) != (1, 0):
        _fail(f"hubert duration decode: K1 launches {k1}, expected 1 and 0")
    out["k1"]["errs"].append(_floats_agree(
        "hubert duration decode, given durations", {"u": ys["tail"]}, {"u": ys["plain"]},
        {"u": HUBERT_FRAMES * up}))
    out["k1_launches"] += k1["tail"]
    _reset_launch_counts()
    res, pred = _decode_floats(["--dumpdir", ddump, "--checkpoint", p["ckpt"], "--config",
                                p["tail"], "--device", "cuda", "--outdir",
                                os.path.join(dur, "wav")])
    y = pred.get("utt0-feats_gen.wav")
    print(f"main path [hubert duration decode through bin/decode, predicted durations]: "
          f"K1 launches = {fused_hifigan_tail.launches}, {0 if y is None else len(y)} "
          f"samples for {len(ids)} ids; RTF {_rtfs(res)} on {card}")
    if (fused_hifigan_tail.launches != 1 or y is None or len(y) % up
            or not np.isfinite(y).all()):
        _fail("hubert duration decode through the predictor")
    out["k1_launches"] += 1

    # 3. StyleMelGAN: 3 utterances with speakers, use_pallas_tade and plain,
    # the same noise
    sty = os.path.join(root, "style")
    sdump = _token_dump(os.path.join(sty, "dump"), HUBERT_UTTS, speakers=True)
    p = _hubert_checkpoint(sty, HUBERT_STYLE_CONFIG,
                           {"tade": {"use_pallas_tade": True}, "plain": {}})
    k8, wavs = {}, {}
    for name in ("tade", "plain"):
        _reset_launch_counts()
        np.random.seed(SEED)  # the same noise in both runs
        res, wavs[name] = _decode_floats(
            ["--dumpdir", sdump, "--checkpoint", p["ckpt"], "--config", p[name],
             "--device", "cuda", "--outdir", os.path.join(sty, f"wav_{name}")])
        k8[name] = (fused_tade_blocks.launches_k8a, fused_tade_blocks.launches_k8b)
        print(f"main path [hubert StyleMelGAN decode, {name}]: K8a/K8b launches = "
              f"{k8[name]} for {len(HUBERT_UTTS)} utterances; RTF {_rtfs(res)} on {card}")
    # noise of (T - 1) // 56 + 1 frames: 560, 336 and 112 padded ids, blocks
    # of input length 4096 or more: 2-8, 3-8 and 4-8
    if k8 != {"tade": (18, 18), "plain": (0, 0)}:
        _fail(f"hubert StyleMelGAN decode: K8 launches {k8}, expected 18 each and 0")
    # K8's decode bound, as phase 13's: 2e-4 (the TADE chain's output is
    # small at a random init, so no bound relative to it)
    out["k8_err"] = _floats_agree("hubert StyleMelGAN decode", wavs["tade"],
                                  wavs["plain"], lengths, relative=False)
    out["k8a_launches"], out["k8b_launches"] = k8["tade"]
    shutil.rmtree(root)

    # 4. StyleMelGAN training at 16 x 17920 through K8/K9 and plain
    def style_config(kernel):
        return dict(_hubert_config(HUBERT_STYLE_CONFIG, use_pallas_tade_train=kernel),
                    **HUBERT_TRAIN_OVERRIDES)

    steps = HUBERT_TRAIN_OVERRIDES["train_max_steps"]
    g_forwards = steps + (steps - HUBERT_TRAIN_OVERRIDES["discriminator_train_start_steps"]
                          - 1) + 2  # G steps, D re-runs, the eval batch and its dump
    blocks = 6  # blocks 3-8 at a crop of 56 ids (T = 1120 .. 17920)
    _hubert_train(
        card, "hubert StyleMelGAN", style_config,
        {"K8a": lambda: fused_tade_blocks.launches_k8a,
         "K8b": lambda: fused_tade_blocks.launches_k8b,
         "K9a": lambda: tade_block_backward.launches_k9a,
         "K9b": lambda: tade_block_backward.launches_k9b},
        {"kernel": (g_forwards * blocks,) * 2 + (steps * blocks,) * 2,
         "plain": (0, 0, 0, 0)}, frames=(60, 90))
    out["k8a_launches"] += g_forwards * blocks
    out["k8b_launches"] += g_forwards * blocks
    out["k9_launches"] = steps * blocks
    b, t = HUBERT_STYLE_CONFIG["batch_size"], HUBERT_STYLE_CONFIG["batch_max_steps"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, 100, (b, 1, t // up), generator=g, device="cuda")
    spk = torch.randint(0, 128, (b, 1, 1), generator=g, device="cuda").expand(-1, 1, t // up)
    batch = {"y": 0.3 * torch.randn(b, 1, t, generator=g, device="cuda"),
             "c": torch.cat([ids, spk], 1).float()}
    _train_split(card, "hubert StyleMelGAN", style_config, batch)

    # 5. the duration model's training at 16 x 10240 (no kernel)
    def duration_config(kernel):
        return dict(_hubert_config(HUBERT_DURATION_CONFIG),
                    **HIFIGAN_TRAIN_OVERRIDES)

    logged = _hubert_train(card, "hubert duration HiFi-GAN", duration_config,
                           {"K1": lambda: fused_hifigan_tail.launches},
                           {"plain": (0,)}, frames=(40, 70))
    d_loss = [logged["plain"][s].get("train/duration_loss") for s in range(1, steps + 1)]
    print(f"hubert duration HiFi-GAN training: duration loss by step {d_loss} on {card}")
    if sum(v is not None for v in d_loss) < steps - 1:
        _fail(f"hubert duration training: duration losses {d_loss}")
    print(f"phase 35 (hubert vocoders) took {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# phase 36: the VQ-VAE and the U-Net HiFi-GAN. The whole of
# egs/vctk/vq1/conf/conditioned_melgan_vae.v3.yaml (a test holds it equal to
# the file): 24 kHz waves, 128 speakers, a MelGAN-D encoder down 4 4 2 2 to
# a 512 x 256 codebook, a MelGAN decoder of 512 channels from 256 + 128
VQ_VCTK_CONFIG = dict(
    sampling_rate=24000, global_gain_scale=1.0, trim_silence=True,
    trim_threshold_in_db=20, trim_frame_size=1024, trim_hop_size=256,
    use_global_condition=True, format="hdf5", generator_type="VQVAE",
    generator_params=dict(
        in_channels=1, out_channels=1, num_embeds=512, embed_dim=256,
        num_global_embeds=128, global_embed_dim=128,
        encoder_type="MelGANDiscriminator", decoder_type="MelGANGenerator",
        encoder_conf=dict(out_channels=256, downsample_scales=[4, 4, 2, 2],
                          max_downsample_channels=1024),
        decoder_conf=dict(in_channels=384, upsample_scales=[4, 4, 2, 2], channels=512,
                          stacks=3)),
    discriminator_type="MelGANMultiScaleDiscriminator",
    discriminator_params=dict(
        in_channels=1, out_channels=1, scales=3, downsample_pooling="AvgPool1d",
        downsample_pooling_params=dict(kernel_size=4, stride=2, padding=1,
                                       count_include_pad=False),
        kernel_sizes=[5, 3], channels=16, max_downsample_channels=1024,
        downsample_scales=[4, 4, 4, 4], nonlinear_activation="LeakyReLU",
        nonlinear_activation_params={"negative_slope": 0.2}, use_weight_norm=True),
    stft_loss_params=dict(fft_sizes=[1024, 2048, 512], hop_sizes=[120, 240, 50],
                          win_lengths=[600, 1200, 240], window="hann_window"),
    use_feat_match_loss=True, lambda_commit=0.25, lambda_feat_match=25.0,
    lambda_adv=4.0, lambda_aux_after_introduce_adv_loss=1.0, batch_size=16,
    batch_max_steps=8192, pin_memory=True, num_workers=2, remove_short_samples=False,
    allow_cache=True,
    generator_optimizer_params=dict(lr=1.0e-4, eps=1.0e-6, weight_decay=0.0),
    generator_scheduler_params=dict(step_size=5000000, gamma=0.5),
    generator_grad_norm=10,
    discriminator_optimizer_params=dict(lr=5.0e-5, eps=1.0e-6, weight_decay=0.0),
    discriminator_scheduler_params=dict(step_size=5000000, gamma=0.5),
    discriminator_grad_norm=1, discriminator_train_start_steps=100000,
    train_max_steps=5000000, save_interval_steps=5000, eval_interval_steps=1000,
    log_interval_steps=100, num_save_intermediate_results=4,
)
# the whole of egs/opencpop/voc1/conf/uhifigan.v1.yaml (a test holds it
# equal to the file): 24 kHz, hop 300, 32 channels doubling to 512, down 5
# 5 4 3 and up 3 4 5 5, HiFi-GAN v1's discriminators
UHIFIGAN_OPENCPOP_CONFIG = dict(
    sampling_rate=24000, fft_size=2048, hop_size=300, win_length=1200, window="hann",
    num_mels=80, fmin=80, fmax=7600, global_gain_scale=1.0, trim_silence=False,
    trim_threshold_in_db=20, trim_frame_size=1024, trim_hop_size=256, format="hdf5",
    generator_type="UHiFiGANGenerator",
    generator_params=dict(
        in_channels=80, out_channels=1, channels=32, kernel_size=7,
        downsample_scales=[5, 5, 4, 3], downsample_kernel_sizes=[10, 10, 8, 6],
        upsample_scales=[3, 4, 5, 5], upsample_kernel_sizes=[6, 8, 10, 10],
        resblock_kernel_sizes=[3, 7, 11],
        resblock_dilations=[[1, 3, 5], [1, 3, 5], [1, 3, 5]], dropout=0.1,
        use_additional_convs=True, bias=True, nonlinear_activation="LeakyReLU",
        nonlinear_activation_params={"negative_slope": 0.1}, use_weight_norm=True),
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=dict(
        scales=3, scale_downsample_pooling="AvgPool1d",
        scale_downsample_pooling_params=dict(kernel_size=4, stride=2, padding=2),
        scale_discriminator_params=dict(
            in_channels=1, out_channels=1, kernel_sizes=[15, 41, 5, 3], channels=128,
            max_downsample_channels=1024, max_groups=16, bias=True,
            downsample_scales=[4, 4, 4, 4, 1], nonlinear_activation="LeakyReLU",
            nonlinear_activation_params={"negative_slope": 0.1}),
        follow_official_norm=True, periods=[2, 3, 5, 7, 11],
        period_discriminator_params=dict(
            in_channels=1, out_channels=1, kernel_sizes=[5, 3], channels=32,
            downsample_scales=[3, 3, 3, 3, 1], max_downsample_channels=1024, bias=True,
            nonlinear_activation="LeakyReLU",
            nonlinear_activation_params={"negative_slope": 0.1}, use_weight_norm=True,
            use_spectral_norm=False)),
    use_stft_loss=True,
    stft_loss_params=dict(fft_sizes=[1024, 2048, 512], hop_sizes=[120, 240, 50],
                          win_lengths=[600, 1200, 240], window="hann_window"),
    use_mel_loss=True,
    mel_loss_params=dict(fs=24000, fft_size=2048, hop_size=300, win_length=1200,
                         window="hann", num_mels=80, fmin=0, fmax=12000, log_base=None),
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    use_feat_match_loss=True,
    feat_match_loss_params=dict(average_by_discriminators=False, average_by_layers=False,
                                include_final_outputs=False),
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0, batch_size=16,
    batch_max_steps=8400, pin_memory=True, num_workers=2, remove_short_samples=False,
    allow_cache=False, generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=0.0002, betas=[0.5, 0.9], weight_decay=0.0),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5, milestones=[200000, 400000, 600000, 800000]),
    generator_grad_norm=-1, discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=0.0002, betas=[0.5, 0.9], weight_decay=0.0),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5,
                                        milestones=[200000, 400000, 600000, 800000]),
    discriminator_grad_norm=-1, generator_train_start_steps=1,
    discriminator_train_start_steps=0, train_max_steps=2500000,
    save_interval_steps=10000, eval_interval_steps=1000, log_interval_steps=100,
    num_save_intermediate_results=4, f0min=80.0, f0max=750.0,
)
# the whole of egs/yesno/voc1/conf/uhifigan.v1.debug.yaml (a test holds it
# equal to the file): AdamW and ExponentialLR, G from step 6
UHIFIGAN_YESNO_DEBUG_CONFIG = dict(
    sampling_rate=8000, fft_size=1024, hop_size=256, win_length=None, window="hann",
    num_mels=80, fmin=80, fmax=3800, global_gain_scale=1.0, trim_silence=True,
    trim_threshold_in_db=20, trim_frame_size=1024, trim_hop_size=256, format="hdf5",
    generator_type="UHiFiGANGenerator",
    generator_params=dict(
        UHIFIGAN_OPENCPOP_CONFIG["generator_params"], downsample_scales=[2, 2, 8, 8],
        downsample_kernel_sizes=[4, 4, 16, 16], upsample_scales=[8, 8, 2, 2],
        upsample_kernel_sizes=[16, 16, 4, 4]),
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=dict(
        scales=2, scale_downsample_pooling="AvgPool1d",
        scale_downsample_pooling_params=dict(kernel_size=4, stride=2, padding=2),
        scale_discriminator_params=dict(
            UHIFIGAN_OPENCPOP_CONFIG["discriminator_params"]["scale_discriminator_params"],
            channels=16, max_downsample_channels=32, downsample_scales=[4, 4, 4, 4]),
        follow_official_norm=True, periods=[2, 3],
        period_discriminator_params=dict(
            UHIFIGAN_OPENCPOP_CONFIG["discriminator_params"]["period_discriminator_params"],
            downsample_scales=[4, 4, 4, 4], max_downsample_channels=32)),
    use_stft_loss=False, use_mel_loss=True,
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    use_feat_match_loss=True,
    feat_match_loss_params=dict(average_by_discriminators=False, average_by_layers=False,
                                include_final_outputs=True),
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0, batch_size=2,
    batch_max_steps=4096, pin_memory=True, num_workers=2, remove_short_samples=False,
    allow_cache=True, generator_optimizer_type="AdamW",
    generator_optimizer_params=dict(lr=0.0002, betas=[0.8, 0.99], weight_decay=0.0),
    generator_scheduler_type="ExponentialLR", generator_scheduler_params={"gamma": 0.999},
    generator_grad_norm=-1, discriminator_optimizer_type="AdamW",
    discriminator_optimizer_params=dict(lr=0.0002, betas=[0.8, 0.99], weight_decay=0.0),
    discriminator_scheduler_type="ExponentialLR",
    discriminator_scheduler_params={"gamma": 0.999}, discriminator_grad_norm=-1,
    generator_train_start_steps=5, discriminator_train_start_steps=0, train_max_steps=10,
    save_interval_steps=5, eval_interval_steps=5, log_interval_steps=5,
    num_save_intermediate_results=4,
)
# phase 36's VQ-VAE decodes: 3 utterances of these many samples (4, 2 and
# 0.5 s at 24 kHz, none a multiple of the 1024-sample bucket), each with a
# speaker; its training: 16 utterances (a batch of 16 needs 16) of
# 9000-16000 samples, 4 steps with D from step 3 (the config's own start
# is 100000)
VQ_UTTS = (96000, 48100, 12345)
VQ_TRAIN_UTTS = 16
VQ_TRAIN_SPAN = (9000, 16000)
# the U-Net HiFi-GAN's: 16 utterances of 40-70 frames, 4 G+D steps (the
# start steps -1: G and D from the first), 3 decoded utterances of these
# many frames
UHIFIGAN_TRAIN_UTTS = 16
UHIFIGAN_TRAIN_OVERRIDES = dict(TRAIN_OVERRIDES, generator_train_start_steps=-1,
                                discriminator_train_start_steps=-1)
UHIFIGAN_UTTS = (320, 150, 41)


def _vq_dump(root: str, lengths, speakers: int, seed: int) -> str:
    """An npy dump of random 24 kHz waves (``*-wave.npy``: harmonics of a
    random f0 plus noise) and their speaker ids (``*-global.npy``)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 24000.0
        audio = (0.3 * np.sin(2 * np.pi * rs.uniform(90, 250) * t)
                 + 0.05 * rs.randn(n)).astype(np.float32)
        np.save(os.path.join(root, f"utt{i}-wave.npy"), audio)
        np.save(os.path.join(root, f"utt{i}-global.npy"), np.array([rs.randint(speakers)]))
    return root


def _vq_config(train_kernel: bool = False, decode_kernel: bool = False,
               **overrides) -> dict:
    cfg = json.loads(json.dumps(VQ_VCTK_CONFIG))
    cfg["format"] = "npy"
    cfg["generator_params"]["decoder_conf"].update(
        use_pallas_stacks_train=train_kernel, use_pallas_stacks=decode_kernel)
    cfg.update(overrides)
    return cfg


def _k7_agrees(label: str, x, stacks, fin, slope: float, seed: int) -> float:
    """K7 against autograd through K6's plain version on one stage (phase
    17's check: the input moved off LeakyReLU's kinks, a cotangent of scale
    1 / sqrt(B T), every gradient within |diff| <= 2e-4 + 1e-3 |plain| and
    1e-4 max|plain|); returns max|diff|."""
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import melgan_stacks_reference
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        STACK_KEYS,
        fused_melgan_stacks_train,
    )

    x, moved = _off_the_kinks(x, stacks, fin, "reflect", slope, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    out_ch = x.shape[2] if fin is None else fin[0].shape[2]
    u = torch.randn(*x.shape[:2], out_ch, generator=g, device="cuda") / (
        x.shape[0] * x.shape[1]) ** 0.5
    grads = []
    for fn in (fused_melgan_stacks_train, melgan_stacks_reference):
        leaves = [x.clone().requires_grad_()]
        sts = []
        for st in stacks:
            d = {"dilation": st["dilation"]}
            for k in STACK_KEYS:
                d[k] = st[k].clone().requires_grad_()
                leaves.append(d[k])
            sts.append(d)
        fv = None if fin is None else tuple(v.clone().requires_grad_() for v in fin)
        leaves += list(fv or ())
        y = fn(leaves[0], sts, final=fv, slope=slope, pad_mode="reflect")
        grads.append(torch.autograd.grad((y * u).sum(), leaves))
    err = 0.0
    for i, (a, b) in enumerate(zip(*grads)):
        if not _grads_agree(a, b):
            _fail(f"K7 [{label}] gradient {i}: max|diff| {float((a - b).abs().max()):.3e}, "
                  f"max|plain| {float(b.abs().max()):.3e}")
        err = max(err, float((a - b).abs().max()))
    print(f"K7 vs plain [{label}]: {len(grads[1])} gradients within |diff| <= {TOL} + "
          f"1e-3 |plain| and 1e-4 max|plain|, max|diff| = {err:.3e} ({moved} input rows "
          "moved off the kinks)")
    return err


def _uhifigan_dump(root: str, frames, config: dict, seed: int) -> str:
    """An npy dump as the port's preprocess writes it for a U-Net HiFi-GAN:
    a sine of a random f0 plus noise, its mel (``ops/mel.py``), and the f0
    and excitation of ``ops/f0.py`` (one excitation row a frame)."""
    import numpy as np

    from parallelwavegan_tpu_torch.ops.f0 import extract_f0_and_excitation
    from parallelwavegan_tpu_torch.ops.mel import logmelfilterbank

    rs = np.random.RandomState(seed)
    hop, fs = config["hop_size"], config["sampling_rate"]
    os.makedirs(root)
    for i, n in enumerate(frames):
        t = n * hop
        audio = (0.3 * np.sin(2 * np.pi * rs.uniform(100, 300) * np.arange(t) / fs)
                 + 0.02 * rs.randn(t)).astype(np.float32)
        mel = logmelfilterbank(audio, fs, fft_size=config["fft_size"], hop_size=hop,
                               win_length=config["win_length"], num_mels=config["num_mels"],
                               fmin=config["fmin"], fmax=config["fmax"])[:n]
        f0, exc = extract_f0_and_excitation(audio, fs, hop, fmin=config.get("f0min", 70.0),
                                            fmax=config.get("f0max", 340.0))
        for name, arr in (("wave", audio), ("feats", mel), ("f0", f0[:n]),
                          ("excitation", exc.reshape(n, hop))):
            np.save(os.path.join(root, f"utt{i}-{name}.npy"), arr.astype(np.float32))
    return root


def _uhifigan_cross_check(card: str) -> float:
    """Step 1 (G+D) of the opencpop U-Net HiFi-GAN at full width and B=2
    (dropout 0) on the card and on the CPU from the same weights and batch,
    TF32 off on both: every loss to 1e-5 relative."""
    import torch

    from parallelwavegan_tpu_torch.models import get_model_class
    from parallelwavegan_tpu_torch.optimizers import build_optimizer_from_config
    from parallelwavegan_tpu_torch.train.criterion import build_criterion
    from parallelwavegan_tpu_torch.train.step import TrainStep

    cfg = json.loads(json.dumps(UHIFIGAN_OPENCPOP_CONFIG))
    cfg["generator_params"]["dropout"] = 0.0
    g = torch.Generator().manual_seed(SEED + 2)
    t, hop = cfg["batch_max_steps"], cfg["hop_size"]
    batch = {"y": 0.3 * torch.randn(2, 1, t, generator=g),
             "c": torch.randn(2, 80, t // hop, generator=g),
             "excitation": 0.1 * torch.randn(2, 1, t, generator=g)}
    got = {}
    for device in ("cuda", "cpu"):
        init = torch.Generator().manual_seed(SEED)  # the same weights on both
        gd = get_model_class(cfg["generator_type"])(
            **cfg["generator_params"], generator=init).to(device)
        dd = get_model_class(cfg["discriminator_type"])(
            **cfg["discriminator_params"], generator=init).to(device)
        step = TrainStep(cfg, gd, dd, build_criterion(cfg),
                         build_optimizer_from_config(cfg, "generator", gd.parameters()),
                         build_optimizer_from_config(cfg, "discriminator", dd.parameters()))
        t0 = time.perf_counter()
        got[device] = {k: float(v) for k, v in step(
            {k: v.to(device) for k, v in batch.items()}, True, True, 0).items()}
        print(f"U-Net HiFi-GAN G+D TrainStep at B=2 T={t} on {device}: "
              f"{time.perf_counter() - t0:.1f} s (first call, host clock)")
        del gd, dd, step
    if sorted(got["cuda"]) != sorted(got["cpu"]):
        _fail(f"U-Net HiFi-GAN cross-check: metrics {sorted(got['cuda'])} vs "
              f"{sorted(got['cpu'])}")
    rel = {k: abs(got["cuda"][k] - v) / max(abs(v), 1e-30) for k, v in got["cpu"].items()}
    print(f"U-Net HiFi-GAN step 1 (G+D), card ({card}) vs CPU, relative loss diffs "
          "(tol 1e-5): " + ", ".join(f"{k} {r:.2e}" for k, r in sorted(rel.items())))
    bad = {k: (got["cuda"][k], got["cpu"][k]) for k, r in rel.items() if not r <= 1e-5}
    if bad:
        _fail(f"U-Net HiFi-GAN cross-check, card vs CPU: {bad}")
    return max(rel.values())


def phase_vq_uhifigan(card: str) -> dict:
    """The VQ-VAE (conditioned_melgan_vae.v3.yaml) and the U-Net HiFi-GAN
    (opencpop uhifigan.v1.yaml) at the widths of their shipped configs
    (module docstring, phase 36)."""
    import numpy as np
    import torch

    import parallelwavegan_tpu_torch.models.melgan as melgan_mod
    from parallelwavegan_tpu_torch.bin import decode, train
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        melgan_stacks_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack_train import (
        melgan_stacks_backward,
    )
    from parallelwavegan_tpu_torch.utils.model import load_model

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "vq_uhifigan")
    shutil.rmtree(root, ignore_errors=True)
    out = {"k6": {"errs": []}, "k7_errs": []}

    # 1. the VQ-VAE trained through bin/train.main at 16 x 8192, the decoder's
    # stages of 128, 64 and 32 channels through K6/K7 and plain
    steps = HUBERT_TRAIN_OVERRIDES["train_max_steps"]
    g_forwards = steps - HUBERT_TRAIN_OVERRIDES["discriminator_train_start_steps"] - 1 + 2
    expect = {"kernel": (steps * (10 + 8) + g_forwards * 10, steps * 10), "plain": (0, 0)}
    dump = _vq_dump(os.path.join(root, "train_dump"), [
        VQ_TRAIN_SPAN[0] + (VQ_TRAIN_SPAN[1] - VQ_TRAIN_SPAN[0]) * i // (VQ_TRAIN_UTTS - 1)
        for i in range(VQ_TRAIN_UTTS)], 128, SEED)
    logged = {}
    for name in ("kernel", "plain"):
        config = os.path.join(root, f"train_{name}.json")
        with open(config, "w") as f:
            json.dump(_vq_config(train_kernel=name == "kernel", **HUBERT_TRAIN_OVERRIDES), f)
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = train.main(["--train-dumpdir", dump, "--dev-dumpdir", dump, "--outdir",
                          os.path.join(root, f"exp_{name}"), "--device", "cuda",
                          "--verbose", "0", "--config", config])
        seconds = time.perf_counter() - t0
        got = (fused_melgan_stacks.launches, melgan_stacks_backward.launches)
        print(f"main path [VQ-VAE v3 training, {name}]: {res['steps']} steps in "
              f"{seconds:.1f} s (set-up, eval and saves included) on {card}; K6 launches "
              f"= {got[0]} (by width {fused_melgan_stacks.launches_by_width}), K7 "
              f"launches = {got[1]}")
        if res["steps"] != steps or got != expect[name]:
            _fail(f"VQ-VAE training {name}: steps {res['steps']}, launches {got}, "
                  f"expected {steps} and {expect[name]}")
        logged[name] = {}
        for s, m in res["history"]:
            logged[name].setdefault(s, {}).update(
                {k: v for k, v in m.items() if k.startswith("train/")})
        for s in range(1, steps + 1):
            m = logged[name].get(s, {})
            print(f"  {name} step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
            if ("train/quantization_loss" not in m
                    or not all(np.isfinite(v) for v in m.values())):
                _fail(f"VQ-VAE training {name}: step {s} logged {m}")
        if "train/discriminator_loss" not in logged[name][steps]:
            _fail(f"VQ-VAE training {name}: the D phase did not run")
        if not any("eval/commitment_loss" in m for _, m in res["history"]):
            _fail(f"VQ-VAE training {name}: no evaluation was logged")
    err = _losses_agree("VQ-VAE kernel vs plain", logged["kernel"], logged["plain"],
                        range(1, steps + 1))
    print(f"VQ-VAE v3 training losses, K6/K7 vs plain: max relative diff = {err:.3e} over "
          f"steps 1-{steps} (tol 1e-4)")
    out["k6_launches"], out["k7_launches"] = expect["kernel"]
    # K7 at the decoder's training stages (B=16: T = 2048, 4096, 8192 at C =
    # 128, 64, 32, the last with the final conv), random weights of gain one
    rs = np.random.RandomState(SEED + 3)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    b, t = VQ_VCTK_CONFIG["batch_size"], VQ_VCTK_CONFIG["batch_max_steps"]
    for i, (c, tt) in enumerate(((128, t // 4), (64, t // 2), (32, t)), start=1):
        stacks = _unit_gain_stacks(rs, c, (1, 3, 9))
        fin = ((randn(7, c, 1, scale=0.3 * (7 * c) ** -0.5), randn(1, scale=0.1))
               if i == 3 else None)
        out["k7_errs"].append(_k7_agrees(
            f"VQ decoder training stage {i} B={b} T={tt} C={c}" + (" + final" if fin else ""),
            randn(b, tt, c), stacks, fin, 0.2, SEED + 10 + i))

    # 2. decode of the trained checkpoint through bin/decode.main: 3
    # utterances with speakers, decoder_conf.use_pallas_stacks (K6) and plain
    ddump = _vq_dump(os.path.join(root, "decode_dump"), VQ_UTTS, 128, SEED + 1)
    ckpt = os.path.join(root, "exp_kernel", f"checkpoint-{steps}steps.pkl")
    calls, real_k6 = [], melgan_mod.fused_melgan_stacks

    def keep(x, *args, **kwargs):  # the first utterance's stage inputs, for the timing
        if len(calls) < 3:
            calls.append(x.clone())
        return real_k6(x, *args, **kwargs)

    wavs, texts, k6 = {}, {}, {}
    melgan_mod.fused_melgan_stacks = keep
    try:
        for name in ("kernel", "plain"):
            config = os.path.join(root, f"decode_{name}.json")
            with open(config, "w") as f:
                json.dump(_vq_config(decode_kernel=name == "kernel"), f)
            outdir = os.path.join(root, f"wav_{name}")
            _reset_launch_counts()
            res, wavs[name] = _decode_floats(["--dumpdir", ddump, "--checkpoint", ckpt,
                                              "--config", config, "--device", "cuda",
                                              "--outdir", outdir])
            k6[name] = fused_melgan_stacks.launches
            with open(os.path.join(outdir, "text")) as f:
                texts[name] = f.read()
            print(f"main path [VQ-VAE v3 decode, {name}]: K6 launches = {k6[name]} for "
                  f"{len(VQ_UTTS)} utterances of {VQ_UTTS} samples; RTF {_rtfs(res)} on {card}")
    finally:
        melgan_mod.fused_melgan_stacks = real_k6
    if k6 != {"kernel": 10 * len(VQ_UTTS), "plain": 0}:
        _fail(f"VQ-VAE decode: K6 launches {k6}, expected {10 * len(VQ_UTTS)} and 0")
    lengths = {f"utt{i}-wave_gen.wav": n for i, n in enumerate(VQ_UTTS)}
    out["k6"]["errs"].append(_floats_agree("VQ-VAE v3 decode", wavs["kernel"], wavs["plain"],
                                           lengths))
    out["k6_launches"] += k6["kernel"]
    lines = texts["kernel"].splitlines()
    ids = [len(line.split()) - 1 for line in lines]
    print(f"VQ-VAE symbol files, K6 vs plain decode: identical = "
          f"{texts['kernel'] == texts['plain']}; ids per utterance {ids}")
    if texts["kernel"] != texts["plain"] or ids != [-(-n // 64) for n in VQ_UTTS]:
        _fail(f"VQ-VAE decode: the symbol files differ or hold {ids} ids")

    # K6 alone at the first utterance's decoder stages (96000 samples padded
    # to 96256: T = 24064, 48128, 96256 at C = 128, 64, 32), the split kept
    with open(os.path.join(root, "decode_kernel.json")) as f:
        model = load_model(ckpt, json.load(f), device="cuda")
    dec = model.generator.decoder
    if dec.fused_stages != (1, 2, 3) or [tuple(x.shape) for x in calls] != [
            (1, 24064, 128), (1, 48128, 64), (1, 96256, 32)]:
        _fail(f"VQ-VAE decoder: fused stages {dec.fused_stages}, K6 inputs "
              f"{[tuple(x.shape) for x in calls]}")
    stages = [(x, dec._kernel_cache[i], dec.stage_weights(i)) for i, x in
              zip(dec.fused_stages, calls)]
    kw = dict(slope=dec.slope, pad_mode=dec.pad_mode)
    rec = {"flops": 0.0, "bytes": 0.0}
    with torch.inference_mode():
        for x, kept, plain_w in stages:
            got = fused_melgan_stacks(x, kept["stacks"], final=kept["final"], **kw)
            want = melgan_stacks_reference(x, plain_w["stacks"], final=plain_w["final"], **kw)
            e, r, ok = _within(got, want)
            print(f"K6 vs plain [VQ decoder stage {tuple(x.shape)}, decode's weights]: "
                  f"max|diff| = {e:.3e} (tol {TOL}), {r:.2e} of max|plain| (tol 1e-4)")
            if not ok:
                _fail(f"K6 at the VQ decoder's stage {tuple(x.shape)} disagrees")
            out["k6"]["errs"].append(e)
            work = _stacks_work(x, plain_w["stacks"], plain_w["final"])
            rec["flops"] += work["flops"]
            rec["bytes"] += work["bytes"]

        def decode_k6(fn=fused_melgan_stacks, plain=False):
            for x, kept, plain_w in stages:
                w = plain_w if plain else kept
                fn(x, w["stacks"], final=w["final"], **kw)

        ms = _median_ms(decode_k6)
        plain_ms = _median_ms(lambda: decode_k6(melgan_stacks_reference, plain=True))
    rec.update(_bound(rec["flops"], rec["bytes"]))
    fp32_ms = _split_tf32_bound(rec)
    out["k6"].update(ms=ms, plain_ms=plain_ms, bound_ms=rec["bound_ms"])
    print(f"time [K6, VQ-VAE v3 decoder stages 1-3 of a {VQ_UTTS[0]}-sample utterance in "
          f"one window, split kept, median of 10, CUDA events]: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.3f} ms at the split-TF32 rate (3 x "
          f"{rec['flops'] / 1e9:.1f} GFLOP / 495 TFLOP/s; {rec['bound_ms'] / ms:.1%} of it), "
          f"{fp32_ms:.3f} ms at the float32 rate, {rec['bytes'] / 1e6:.1f} MB on {card}")
    del model, dec, stages, calls
    shutil.rmtree(os.path.join(root, "train_dump"))

    # 3. the U-Net HiFi-GAN at 16 x 8400: 4 G+D steps through bin/train.main
    # (no kernel: every launch count stays 0), step 1 against the CPU, a
    # decode with f0 and excitation, and the yesno debug recipe's AdamW +
    # ExponentialLR for 2 steps
    cfg = json.loads(json.dumps(UHIFIGAN_OPENCPOP_CONFIG))
    hop = cfg["hop_size"]
    udump = _uhifigan_dump(os.path.join(root, "uhifigan_dump"), [
        40 + 30 * i // (UHIFIGAN_TRAIN_UTTS - 1) for i in range(UHIFIGAN_TRAIN_UTTS)],
        cfg, SEED)
    config = os.path.join(root, "uhifigan.json")
    with open(config, "w") as f:
        json.dump(dict(cfg, **UHIFIGAN_TRAIN_OVERRIDES), f)
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = train.main(["--train-dumpdir", udump, "--dev-dumpdir", udump, "--outdir",
                      os.path.join(root, "exp_uhifigan"), "--device", "cuda", "--verbose",
                      "0", "--config", config])
    print(f"main path [U-Net HiFi-GAN (opencpop v1) training]: {res['steps']} steps in "
          f"{time.perf_counter() - t0:.1f} s (set-up, eval and saves included) on {card}")
    logged = {}
    for s, m in res["history"]:
        logged.setdefault(s, {}).update({k: v for k, v in m.items() if k.startswith("train/")})
    need = {"train/mel_loss", "train/spectral_convergence_loss", "train/adversarial_loss",
            "train/feature_matching_loss", "train/real_loss", "train/discriminator_loss"}
    for s in range(1, steps + 1):
        m = logged.get(s, {})
        print(f"  step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
        if not need <= set(m) or not all(np.isfinite(v) for v in m.values()):
            _fail(f"U-Net HiFi-GAN training: step {s} logged {sorted(m)}")
    if res["steps"] != steps or fused_melgan_stacks.launches:
        _fail(f"U-Net HiFi-GAN training: {res['steps']} steps")
    out["uhifigan_cross"] = _uhifigan_cross_check(card)
    sdump = _uhifigan_dump(os.path.join(root, "uhifigan_decode"), UHIFIGAN_UTTS, cfg,
                           SEED + 1)
    res, uwavs = _decode_floats(["--dumpdir", sdump, "--device", "cuda", "--outdir",
                                 os.path.join(root, "wav_uhifigan"), "--checkpoint",
                                 os.path.join(root, "exp_uhifigan",
                                              f"checkpoint-{steps}steps.pkl")])
    for i, n in enumerate(UHIFIGAN_UTTS):
        y = uwavs.get(f"utt{i}-feats_gen.wav")
        if y is None or y.shape != (n * hop,) or not np.isfinite(y).all() or not np.abs(
                y).max() > 0:
            _fail(f"U-Net HiFi-GAN decode: utt{i} {None if y is None else y.shape}")
    print(f"main path [U-Net HiFi-GAN decode with f0 and excitation]: {len(uwavs)} "
          f"utterances of {UHIFIGAN_UTTS} frames; RTF {_rtfs(res)} on {card}")
    ycfg = dict(json.loads(json.dumps(UHIFIGAN_YESNO_DEBUG_CONFIG)), format="npy",
                train_max_steps=2, save_interval_steps=2, eval_interval_steps=2,
                log_interval_steps=1, num_workers=1)
    ydump = _uhifigan_dump(os.path.join(root, "yesno_dump"), (30, 34), ycfg, SEED + 2)
    config = os.path.join(root, "yesno.json")
    with open(config, "w") as f:
        json.dump(ycfg, f)
    res = train.main(["--train-dumpdir", ydump, "--dev-dumpdir", ydump, "--outdir",
                      os.path.join(root, "exp_yesno"), "--device", "cuda", "--verbose", "0",
                      "--config", config])
    ylog = {}
    for s, m in res["history"]:
        ylog.setdefault(s, {}).update(m)
    print("main path [U-Net HiFi-GAN yesno debug recipe, AdamW + ExponentialLR, G only then "
          "D only]: " + "; ".join(f"step {s}: " + ", ".join(
              f"{k} {v:.6f}" for k, v in sorted(m.items()) if k.startswith("train/"))
              for s, m in sorted(ylog.items())))
    if (res["steps"] != 2 or "train/mel_loss" not in ylog.get(1, {})
            or "train/discriminator_loss" not in ylog.get(2, {})
            or not all(np.isfinite(v) for m in ylog.values() for v in m.values())):
        _fail(f"U-Net HiFi-GAN yesno debug training: {res['steps']} steps, logged {ylog}")
    shutil.rmtree(root)
    print(f"phase 36 (VQ-VAE and U-Net HiFi-GAN) took {time.perf_counter() - t_phase:.1f} s "
          f"on {card}")
    return out


# phase 37: a 95 s utterance at hop 256 and 22.05 kHz and a short one that
# falls back to one-shot; PWG v1's and MB-MelGAN v2's streamed utterance;
# two utterances of about 2 s, multiples of the 32-frame bucket (so that
# one-shot is the exact-length forward), for evaluate_mcd; the causal one
SURFACE_FRAMES = (8183, 200)
SURFACE_STREAM_FRAMES = 2500
MCD_FRAMES = (160, 192)
CAUSAL_FRAMES = 200
SHORT_CHUNK = ["--chunk-frames", "64", "--context-frames", "48"]


def _dump_mels(p: dict, frames) -> dict:
    """{wav name decode writes: the dump's mel} of ``_write_inputs``' dump."""
    import numpy as np

    return {f"utt{i}-feats_gen.wav": np.load(os.path.join(p["dump"], f"utt{i}-feats.npy"))
            for i in range(len(frames))}


def _exact_forward(model, c, z=None):
    """``forward_padded`` of the whole normalised mel c at its exact length,
    on the model's device, as (T * upsample_factor,)."""
    import torch

    with torch.inference_mode():
        x = torch.from_numpy(c).to(model.device)
        return model.forward_padded(x, z)[:, 0].cpu().numpy()


def _streamed_pair(card: str, label: str, p: dict, runs: dict, counter, expect: dict,
                   extra=()) -> dict:
    """``bin/decode.main --streaming`` of p's dump once per run (name: (config,
    flags)), the launches of ``counter`` reset just before and read just
    after each; fails unless they are ``expect``. Returns {name: waveforms}."""
    import numpy as np

    wavs, got = {}, {}
    for name, (config, flags) in runs.items():
        _reset_launch_counts()
        np.random.seed(SEED)  # the same noise in every run
        res, wavs[name] = _decode_floats(
            ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"], "--normalize-before",
             "--device", "cuda", "--streaming", "--config", p[config], "--outdir",
             os.path.join(p["root"], f"wav_{name}"), *flags, *extra])
        got[name] = counter.launches
        print(f"main path [{label} streamed, {name}]: launches = {got[name]}; RTF "
              f"{_rtfs(res)} on {card}")
    if got != expect:
        _fail(f"{label} streaming: launches {got}, expected {expect}")
    return wavs


def _past_int32(card: str) -> dict:
    """K3, K6 and K1 on a batch whose last row starts past 2**31 elements of
    its largest tensor (the kernels' offsets are 64-bit; what streaming with
    --chunk-frames 2048 gives K3 at a full batch of 64 windows), the first
    and last rows against their plain versions on B = 1 slices; one kernel
    call each, random weights of gain about one. Returns the max|diff| of
    each kernel."""
    import numpy as np
    import torch

    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        hifigan_tail_reference,
        with_fragments,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import (
        fused_melgan_stacks,
        melgan_stacks_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
        fused_wavenet_stack,
        wavenet_stack_reference,
    )

    rs = np.random.RandomState(SEED + 37)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to("cuda")

    def big(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def held(label, rows, run, plain):
        """run() on the whole batch; its rows 0 and rows - 1 against
        plain(b) on row b alone."""
        with torch.inference_mode():
            got = run()
            got = [g[[0, -1]] for g in (got if isinstance(got, tuple) else (got,))]
            err = 0.0
            for i, b in enumerate((0, rows - 1)):
                want = plain(b)
                for g, w in zip(got, want if isinstance(want, tuple) else (want,)):
                    e, _, ok = _within(g[i: i + 1], w)
                    err = max(err, e)
                    if not ok:
                        _fail(f"{label}: row {b} disagrees with its plain version ({e:.3e})")
        print(f"{label}: rows 0 and {rows - 1} against the plain version on B = 1: "
              f"max|diff| = {err:.3e} (tol {TOL}) on {card}")
        return err

    errs = {}
    # K3: (64, 557056, 64) with c of 80 channels, one v1 layer (d = 512)
    b, t, ch, ca = 64, (2048 + 2 * 64) * 256, 64, 80
    x, c = big(b, t, ch), big(b, t, ca)
    w = {"wconv": randn(1, 3, ch, 2 * ch, scale=(3 * ch) ** -0.5),
         "bconv": randn(1, 2 * ch, scale=0.1), "waux": randn(1, ca, 2 * ch, scale=ca ** -0.5),
         "wskip": randn(1, ch, ch, scale=ch ** -0.5), "bskip": randn(1, ch, scale=0.1),
         "wres": randn(1, ch, ch, scale=ch ** -0.5), "bres": randn(1, ch, scale=0.1)}
    errs["k3"] = held(f"K3 past 2**31 elements {(b, t, ch)} (aux {ca})", b,
                      lambda: fused_wavenet_stack(x, c, w, (512,)),
                      lambda r: wavenet_stack_reference(x[r: r + 1], c[r: r + 1], w, (512,)))
    del x, c
    torch.cuda.empty_cache()
    # K6: (64, 700000, 48), one stack (d = 27) and the final conv to 4
    b, t, ch = 64, 700000, 48
    x = big(b, t, ch)
    stacks = [{"wd": randn(3, ch, ch, scale=(3 * ch) ** -0.5), "bd": randn(ch, scale=0.1),
               "w1": randn(1, ch, ch, scale=ch ** -0.5), "b1": randn(ch, scale=0.1),
               "ws": randn(1, ch, ch, scale=ch ** -0.5), "bs": randn(ch, scale=0.1),
               "dilation": 27}]
    fin = (randn(7, ch, 4, scale=0.3 * (7 * ch) ** -0.5), randn(4, scale=0.1))
    errs["k6"] = held(f"K6 past 2**31 elements {(b, t, ch)}", b,
                      lambda: fused_melgan_stacks(x, stacks, final=fin),
                      lambda r: melgan_stacks_reference(x[r: r + 1], stacks, final=fin))
    del x
    torch.cuda.empty_cache()
    # K1: (64, 262656, 128) -> one stride-2 stage to 64 channels with one
    # residual unit -> the output conv; each stage's tensors past 2**31
    b, t0 = 64, 2 ** 18 + 512
    x = big(b, t0, 128)
    blocks = with_fragments([{"w1": randn(1, 3, 64, 64, scale=(3 * 64) ** -0.5),
                              "b1": randn(1, 64, scale=0.1),
                              "w2": randn(1, 3, 64, 64, scale=(3 * 64) ** -0.5),
                              "b2": randn(1, 64, scale=0.1), "dilations": (1,)}])
    stages = [{"deconv_w": randn(4, 128, 64, scale=256 ** -0.5), "deconv_b": randn(64, scale=0.1),
               "stride": 2, "padding": 1, "blocks": blocks}]
    fw, fb = randn(7, 64, 1, scale=0.3 * (7 * 64) ** -0.5), randn(1, scale=0.1)
    errs["k1"] = held(f"K1 past 2**31 elements {(b, t0, 128)} -> {(b, 2 * t0, 64)}", b,
                      lambda: fused_hifigan_tail(x, stages, fw, fb),
                      lambda r: hifigan_tail_reference(x[r: r + 1], stages, fw, fb))
    del x
    torch.cuda.empty_cache()
    return errs


def phase_decode_surfaces(card: str) -> dict:
    """Streaming, sharded and mesh-batched decode, the causal HiFi-GAN and
    evaluate_mcd on the card (module docstring, phase 37)."""
    import numpy as np
    import torch

    import parallelwavegan_tpu_torch.models.hifigan as hifigan_mod
    from parallelwavegan_tpu_torch.bin import evaluate_mcd
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_mrf import fused_hifigan_mrf
    from parallelwavegan_tpu_torch.ops.kernels.hifigan_tail import (
        fused_hifigan_tail,
        hifigan_tail_reference,
    )
    from parallelwavegan_tpu_torch.ops.kernels.melgan_stack import fused_melgan_stacks
    from parallelwavegan_tpu_torch.ops.kernels.wavenet import fused_wavenet_stack
    from parallelwavegan_tpu_torch.parallel.mesh import make_mesh
    from parallelwavegan_tpu_torch.utils.model import load_model

    t_phase = time.perf_counter()
    past = _past_int32(card)
    out = {"k1_launches": 0, "k1_errs": [past["k1"]], "k3_errs": [past["k3"]],
           "k6_errs": [past["k6"]]}

    def loaded(p, config, **overrides):
        with open(p[config]) as f:
            cfg = json.load(f)
        cfg["generator_params"].update(overrides)
        return load_model(p["ckpt"], cfg, device="cuda")

    # 1. HiFi-GAN v1 streamed through bin/decode.main with and without K1
    p = _write_inputs("HiFiGANGenerator", V1_GENERATOR, {"tail": {"use_pallas_tail": True},
                                                          "plain": {}},
                      frames=SURFACE_FRAMES, name="surfaces_hifigan")
    lengths = {f"utt{i}-feats_gen.wav": n * V1_FEATURES["hop_size"]
               for i, n in enumerate(SURFACE_FRAMES)}
    wavs = _streamed_pair(card, "HiFi-GAN v1", p, {
        "tail": ("tail", ["--use-pallas-tail"]), "plain": ("plain", [])},
        fused_hifigan_tail, {"tail": 4, "plain": 0})
    out["k1_launches"] += 4
    out["k1_errs"].append(_floats_agree("HiFi-GAN v1 streamed decode", wavs["tail"],
                                        wavs["plain"], lengths))
    model, plain = loaded(p, "tail"), loaded(p, "plain")
    mels = {k: model._normalized(m, True) for k, m in _dump_mels(p, SURFACE_FRAMES).items()}
    # the long utterance against the forward of its exact-length mel; the
    # short one fell back to one-shot, which pads to the 32-frame bucket
    _floats_agree("HiFi-GAN v1 streamed decode (K1)", wavs["tail"],
                  {k: _exact_forward(model, c) if len(c) > 256 + 64 else
                   model.inference(c)[:, 0] for k, c in mels.items()},
                  versus="vs the exact-length forward (K1; one-shot for the short one)")
    long = mels["utt0-feats_gen.wav"]
    stats = {}
    for label, fn in (("one-shot", lambda: model.inference(long)),
                      ("streaming", lambda: model.inference_streaming(long))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        stats[label] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated(), held)
    for label, (sec, peak, held) in stats.items():
        print(f"time [HiFi-GAN v1 {label} decode of {SURFACE_FRAMES[0]} frames "
              f"({SURFACE_FRAMES[0] * V1_FEATURES['hop_size'] / V1_FEATURES['sampling_rate']:.1f}"
              f" s of audio) with K1, second call, host clock]: {sec * 1e3:.1f} ms; peak "
              f"device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before "
              f"the call) on {card}")
    # K1 at the interior windows' shape, from the streamed decode's own input
    captured, real = [], hifigan_mod.fused_hifigan_tail

    def keep(x, *args, **kwargs):
        if x.shape[0] > 1:
            captured.append(x.clone())
        return real(x, *args, **kwargs)

    hifigan_mod.fused_hifigan_tail = keep
    try:
        model.inference_streaming(long)
    finally:
        hifigan_mod.fused_hifigan_tail = real
    if [tuple(x.shape) for x in captured] != [(32, 24576, 128)]:
        _fail(f"streamed K1 inputs {[tuple(x.shape) for x in captured]}, expected "
              "[(32, 24576, 128)]")
    x, gen = captured[0], model.generator
    w, plain_w = gen._tail_cache, gen.tail_weights()

    def k1():
        return fused_hifigan_tail(x, w["stages"], w["final_w"], w["final_b"],
                                  slope=gen.slope, pre_blocks=w["pre_blocks"])

    def k1_plain():
        return hifigan_tail_reference(x, plain_w["stages"], plain_w["final_w"],
                                      plain_w["final_b"], slope=gen.slope,
                                      pre_blocks=plain_w["pre_blocks"])

    with torch.inference_mode():
        e, r, ok = _within(k1(), k1_plain())
        print(f"K1 vs plain [streamed interior windows (32, 24576, 128), decode's weights]: "
              f"max|diff| = {e:.3e} (tol {TOL}), {r:.2e} of max|plain| (tol 1e-4)")
        if not ok:
            _fail("K1 at the streamed interior windows disagrees with its plain version")
        out["k1_errs"].append(e)
        ms, plain_ms = _median_ms(k1, reps=5), _median_ms(k1_plain, reps=5)
    rec = _tail_work(x, plain_w)
    fp32_ms = _split_tf32_bound(rec)
    out["k1_stream"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": rec["bound_ms"]}
    print(f"time [K1, streamed interior windows (32, 24576, 128), split kept, median of 5, "
          f"CUDA events]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{rec['bound_ms']:.3f} ms at the split-TF32 rate (3 x {rec['flops'] / 1e9:.1f} "
          f"GFLOP / 495 TFLOP/s; {rec['bound_ms'] / ms:.1%} of it), {fp32_ms:.3f} ms at the "
          f"float32 rate on {card}")
    del captured, x

    # 2. inference_sharded over [cuda:0] x 4 and inference_batch over
    # [cuda:0] x 2, each with K1 and plain
    c = long[:2000]
    batch = [long[:300], long[300:500], long[500:577]]
    for label, mesh, run, ref in (
            ("inference_sharded over [cuda:0] x 4", make_mesh(["cuda:0"] * 4),
             lambda m, mesh: {"u": m.inference_sharded(c, mesh)[:, 0]},
             lambda m: {"u": m.inference(c)[:, 0]}),
            ("inference_batch over [cuda:0] x 2", make_mesh(["cuda:0"] * 2),
             lambda m, mesh: {i: y[:, 0] for i, y in enumerate(m.inference_batch(batch, mesh=mesh))},
             lambda m: {i: y[:, 0] for i, y in enumerate(m.inference_batch(batch))})):
        _reset_launch_counts()
        got = run(model, mesh)
        launches = fused_hifigan_tail.launches
        print(f"main path [HiFi-GAN v1 {label}]: K1 calls = {launches} on {card}")
        if launches != 1:
            _fail(f"HiFi-GAN v1 {label}: K1 calls {launches}, expected 1 (one batch)")
        out["k1_launches"] += launches
        out["k1_errs"].append(_floats_agree(f"HiFi-GAN v1 {label}", got, run(plain, mesh)))
        _floats_agree(f"HiFi-GAN v1 {label} (K1)", got, ref(model),
                      versus="vs " + ("inference" if "sharded" in label else "no mesh"))
    del model, plain
    shutil.rmtree(p["root"])

    # 3. PWG v1 as it ships (K3) and MB-MelGAN v2 with --use-pallas-stacks
    # (K6), streamed on one 2500-frame utterance each
    frames = (SURFACE_STREAM_FRAMES,)
    lengths = {"utt0-feats_gen.wav": SURFACE_STREAM_FRAMES * V1_FEATURES["hop_size"]}
    p = _write_inputs("ParallelWaveGANGenerator", V1_PWG_GENERATOR,
                      {"stack": {}, "plain": {"use_pallas_stack_train": False}},
                      frames=frames, name="surfaces_pwg")
    wavs = _streamed_pair(card, "PWG v1", p, {"stack": ("stack", []), "plain": ("plain", [])},
                          fused_wavenet_stack, {"stack": 90, "plain": 0})
    out["k3_launches"] = 90  # 3 forwards (first window, a batch of 8, last) x 30 layers
    out["k3_errs"].append(_floats_agree("PWG v1 streamed decode", wavs["stack"], wavs["plain"],
                                        lengths))
    model = loaded(p, "stack")
    c = model._normalized(_dump_mels(p, frames)["utt0-feats_gen.wav"], True)
    np.random.seed(SEED)  # the noise decode drew
    z = model._noise((c.shape[0] * model.upsample_factor,), None)
    _floats_agree("PWG v1 streamed decode (K3)", wavs["stack"],
                  {"utt0-feats_gen.wav": _exact_forward(model, c, z)},
                  versus="vs the exact-length forward (K3)")
    del model
    shutil.rmtree(p["root"])
    p = _write_inputs("MelGANGenerator", V2_MB_GENERATOR, {"config": {}}, frames=frames,
                      name="surfaces_mb")
    wavs = _streamed_pair(card, "MB-MelGAN v2", p, {
        "stacks": ("config", ["--use-pallas-stacks"]), "plain": ("config", [])},
        fused_melgan_stacks, {"stacks": 27, "plain": 0})
    out["k6_launches"] = 27  # 3 forwards x 9 launches (stages of 96 and 48 channels)
    out["k6_errs"].append(_floats_agree("MB-MelGAN v2 streamed decode", wavs["stacks"],
                                        wavs["plain"], lengths))
    model = loaded(p, "config", use_pallas_stacks=True)
    c = model._normalized(_dump_mels(p, frames)["utt0-feats_gen.wav"], True)
    _floats_agree("MB-MelGAN v2 streamed decode (K6)", wavs["stacks"],
                  {"utt0-feats_gen.wav": _exact_forward(model, c)},
                  versus="vs the exact-length forward (K6)")
    del model
    shutil.rmtree(p["root"])

    # 4. the causal HiFi-GAN v1, use_pallas_tail set (its gate ignores it),
    # one-shot and streamed on the card against the CPU
    p = _write_inputs("HiFiGANGenerator", dict(V1_GENERATOR, use_causal_conv=True),
                      {"causal": {"use_pallas_tail": True}}, frames=(CAUSAL_FRAMES,),
                      name="surfaces_causal")
    card_wavs = {}
    for mode, flags in (("one-shot", []), ("streamed", ["--streaming", *SHORT_CHUNK])):
        _reset_launch_counts()
        _, card_wavs[mode] = _decode_floats(
            ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"], "--normalize-before",
             "--device", "cuda", "--config", p["causal"], "--use-pallas-tail", "--outdir",
             os.path.join(p["root"], mode), *flags])
        if fused_hifigan_tail.launches or fused_hifigan_mrf.launches:
            _fail(f"causal HiFi-GAN v1 {mode}: a kernel ran")
    with open(p["causal"]) as f:
        cpu = load_model(p["ckpt"], json.load(f), device="cpu")
    name = "utt0-feats_gen.wav"
    c = cpu._normalized(_dump_mels(p, (CAUSAL_FRAMES,))[name], True)
    t0 = time.perf_counter()
    want = {"one-shot": {name: cpu.inference(c)[:, 0]},
            "streamed": {name: _exact_forward(cpu, c)}}
    print(f"causal HiFi-GAN v1 on the CPU ({torch.get_num_threads()} threads): one-shot and "
          f"exact-length forwards of {CAUSAL_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    for mode in ("one-shot", "streamed"):
        _floats_agree(f"causal HiFi-GAN v1 {mode} decode (no kernel)", card_wavs[mode],
                      want[mode], versus="the card vs the CPU" + (
                          "'s exact-length forward" if mode == "streamed" else ""))
    del cpu
    shutil.rmtree(p["root"])

    # 5. evaluate_mcd between streamed and one-shot decodes (K1)
    p = _write_inputs("HiFiGANGenerator", V1_GENERATOR, {"tail": {"use_pallas_tail": True}},
                      frames=MCD_FRAMES, name="surfaces_mcd")
    wavs, dirs = {}, {}
    for mode, flags in (("one-shot", []), ("streamed", ["--streaming", *SHORT_CHUNK])):
        dirs[mode] = os.path.join(p["root"], mode)
        _reset_launch_counts()
        _, wavs[mode] = _decode_floats(
            ["--dumpdir", p["dump"], "--checkpoint", p["ckpt"], "--normalize-before",
             "--device", "cuda", "--config", p["tail"], "--use-pallas-tail", "--outdir",
             dirs[mode], *flags])
        expect = len(MCD_FRAMES) * (3 if flags else 1)
        if fused_hifigan_tail.launches != expect:
            _fail(f"HiFi-GAN v1 {mode} decode for MCD: K1 calls {fused_hifigan_tail.launches}"
                  f", expected {expect}")
        out["k1_launches"] += expect
    _floats_agree("HiFi-GAN v1 decode for MCD (K1)", wavs["streamed"], wavs["one-shot"],
                  versus="streamed (chunk 64, context 48) vs one-shot")
    res = evaluate_mcd.main(["--wavdir", dirs["streamed"], "--gt-wavdir", dirs["one-shot"],
                             "--n_jobs", "2", "--verbose", "0"])
    mcds = res["utt2mcd"]
    print(f"evaluate_mcd, streamed vs one-shot decodes of {MCD_FRAMES} frames: "
          + ", ".join(f"{u} {v:.6f} dB" for u, v in sorted(mcds.items()))
          + f"; mean {res['mean']:.6f} dB (limit 0.01)")
    if len(mcds) != len(MCD_FRAMES) or not max(mcds.values()) < 0.01:
        _fail(f"evaluate_mcd: {mcds}")
    shutil.rmtree(p["root"])
    torch.cuda.empty_cache()
    print(f"phase 37 (decode surfaces) took {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


def main() -> None:
    pkg = os.path.join(ROOT, "parallelwavegan_tpu_torch")
    if not os.path.isdir(pkg):
        _fail(f"{pkg} not found: run this script from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    import parallelwavegan_tpu_torch
    from parallelwavegan_tpu_torch.ops.kernels import build

    if not os.path.abspath(parallelwavegan_tpu_torch.__file__).startswith(pkg):
        _fail(f"imported {parallelwavegan_tpu_torch.__file__}, not {pkg}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    t_main = time.perf_counter()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; card: {card}")

    start = time.perf_counter()
    lib = build.load()
    print(f"kernel build: {time.perf_counter() - start:.1f} s wall, nvcc "
          f"{lib.build_seconds:.1f} s -> {os.path.relpath(lib.path, ROOT)} "
          f"on {card}")
    entry = "?"
    for line in lib.log.splitlines():  # one line per kernel from ptxas -v
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"  ptxas: {entry}: {m.group(1)} registers")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            print(f"  ptxas: {entry}: {line.strip()}")

    kern = phase_kernel(card)
    torch.cuda.synchronize()
    dec = phase_decode(card)
    torch.cuda.synchronize()
    wn = phase_wavenet(card)
    torch.cuda.synchronize()
    phase_pwg_split(card)
    torch.cuda.synchronize()
    pwg = phase_pwg_decode(card)
    torch.cuda.synchronize()
    k6 = phase_melgan_kernel(card)
    torch.cuda.synchronize()
    k2 = phase_mrf_kernel(card)
    torch.cuda.synchronize()
    phase_mbmelgan_split(card)
    torch.cuda.synchronize()
    mb = phase_mbmelgan_decode(card)
    torch.cuda.synchronize()
    k8 = phase_tade_kernel(card)
    torch.cuda.synchronize()
    phase_style_split(card)
    torch.cuda.synchronize()
    style = phase_style_decode(card)
    torch.cuda.synchronize()
    k4 = phase_k4(card)
    torch.cuda.synchronize()
    phase_train_split(card)
    torch.cuda.synchronize()
    pwg_train = phase_train(card)
    torch.cuda.synchronize()
    k7 = phase_k7(card)
    torch.cuda.synchronize()
    phase_melgan_train_split(card)
    torch.cuda.synchronize()
    melgan_train = phase_melgan_train(card)
    torch.cuda.synchronize()
    k9 = phase_k9(card)
    torch.cuda.synchronize()
    phase_style_train_split(card)
    torch.cuda.synchronize()
    style_train = phase_style_train(card)
    torch.cuda.synchronize()
    phase_hifigan_train_split(card)
    torch.cuda.synchronize()
    phase_hifigan_train(card)
    torch.cuda.synchronize()
    k67 = phase_k67_bf16(card)
    torch.cuda.synchronize()
    phase_hifigan_bf16_train(card)
    torch.cuda.synchronize()
    melgan_bf16 = phase_melgan_bf16_train(card)
    torch.cuda.synchronize()
    k89 = phase_k89_bf16(card)
    torch.cuda.synchronize()
    style_bf16 = phase_style_bf16_train(card)
    torch.cuda.synchronize()
    k3_bf16 = phase_k3_bf16(card)
    torch.cuda.synchronize()
    pwg_family = phase_pwg_family(card)
    torch.cuda.synchronize()
    phase_mb_melgan_train_split(card)
    torch.cuda.synchronize()
    mb_train = phase_mb_melgan_train(card)
    torch.cuda.synchronize()
    recipe = phase_recipe(card)
    torch.cuda.synchronize()
    kern["errs"] += recipe["k1"]["errs"]  # K1 at B=4 on the recipe's decode
    hubert = phase_hubert(card)
    torch.cuda.synchronize()
    kern["errs"] += hubert["k1"]["errs"]  # K1 on the hubert decodes
    k8["k8a"]["errs"].append(hubert["k8_err"])
    k8["k8b"]["errs"].append(hubert["k8_err"])
    vq = phase_vq_uhifigan(card)
    torch.cuda.synchronize()
    k6["errs"] += vq["k6"]["errs"]  # K6 on the VQ-VAE decoder's stages
    k7["errs"] += vq["k7_errs"]  # K7 at the VQ-VAE decoder's training stages
    surf = phase_decode_surfaces(card)
    torch.cuda.synchronize()
    kern["errs"] += surf["k1_errs"]  # K1 in the streamed, sharded and mesh-batched decodes
    wn["stack"]["errs"] += surf["k3_errs"]  # K3 in PWG v1's streamed decode
    k6["errs"] += surf["k6_errs"]  # K6 in MB-MelGAN v2's streamed decode
    shutil.rmtree(WORK, ignore_errors=True)

    def entry(name, source, replaces, launches, rec):
        return {"name": name, "route": "cuda",
                "source": f"parallelwavegan_tpu_torch/ops/kernels/csrc/{source}",
                "replaces": f"parallelwavegan_tpu/ops/pallas_kernels/{replaces}",
                "launches": launches, "max_abs_err": max(rec["errs"]),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                # no single PyTorch call computes any of these functions
                "library_ms": None}

    record = {"kernels": [
        entry("fused_hifigan_tail", "hifigan_tail.cu", "hifigan_tail.py:256",
              dec["launches"] + recipe["k1_launches"] + hubert["k1_launches"]
              + surf["k1_launches"], kern),
        entry("fused_wavenet_stack", "wavenet.cu", "wavenet_stack.py:199",
              pwg["stack_launches"] + recipe["k3_launches"] + surf["k3_launches"],
              wn["stack"]),
        entry("fused_gated_resblock", "wavenet.cu", "wavenet.py:280",
              pwg["block_launches"], wn["block"]),
        entry("fused_melgan_stacks", "melgan_stack.cu", "melgan_stack.py:285",
              mb["launches"] + mb_train["k6_launches"] + recipe["k6_launches"]
              + vq["k6_launches"] + surf["k6_launches"], k6),
        entry("fused_hifigan_mrf", "hifigan_tail.cu",
              "hifigan_mrf.py:178 and :399", dec["mrf_launches"], k2),
        entry("fused_tade_blocks (K8a)", "tade.cu", "tade_decode.py:366",
              style["k8a_launches"] + hubert["k8a_launches"], k8["k8a"]),
        entry("fused_tade_blocks (K8b)", "tade.cu", "tade_decode.py:437",
              style["k8b_launches"] + hubert["k8b_launches"], k8["k8b"]),
        entry("wavenet_stack_backward (K4)", "wavenet_bwd.cu",
              "wavenet_stack_train.py:187", pwg_train["k4_launches"], k4),
        entry("melgan_stacks_backward (K7)", "melgan_stack_bwd.cu", "melgan_stack_train.py:247",
              melgan_train["k7_launches"] + mb_train["k7_launches"] + vq["k7_launches"],
              k7),
        entry("tade_block_backward (K9a)", "tade_bwd.cu", "tade_train.py:438",
              style_train["k9a_launches"] + hubert["k9_launches"], k9["k9a"]),
        entry("tade_block_backward (K9b)", "tade_bwd.cu", "tade_train.py:523",
              style_train["k9b_launches"] + hubert["k9_launches"], k9["k9b"]),
        entry("fused_melgan_stacks (K6 bf16-resident mode)", "melgan_stack_bf16.cu",
              "melgan_stack.py:285", melgan_bf16["k6_launches"] + mb_train["k6_bf16_launches"],
              k67["k6"]),
        entry("melgan_stacks_backward (K7 bf16-resident mode)", "melgan_stack_bwd_bf16.cu",
              "melgan_stack_train.py:247",
              melgan_bf16["k7_launches"] + mb_train["k7_bf16_launches"], k67["k7"]),
        # forwards and the Save re-runs inside K9
        entry("fused_tade_blocks_train (K8a bf16-resident mode)", "tade_bf16.cu",
              "tade_decode.py:366", style_bf16["k8a_launches"] + style_bf16["k8a_reruns"],
              k89["k8a"]),
        entry("fused_tade_blocks_train (K8b bf16-resident mode)", "tade_bf16.cu",
              "tade_decode.py:437", style_bf16["k8b_launches"] + style_bf16["k8b_reruns"],
              k89["k8b"]),
        entry("tade_block_backward (K9a bf16-resident mode)", "tade_bwd_bf16.cu",
              "tade_train.py:438", style_bf16["k9a_launches"], k89["k9a"]),
        entry("tade_block_backward (K9b bf16-resident mode)", "tade_bwd_bf16.cu",
              "tade_train.py:523", style_bf16["k9b_launches"], k89["k9b"]),
        entry("fused_wavenet_stack (K3 bf16-resident mode)", "wavenet_bf16.cu",
              "wavenet_stack.py:199", pwg_family["k3_bf16_launches"], k3_bf16),
    ]}
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_main:.1f} s "
          f"(build included) on {card}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
