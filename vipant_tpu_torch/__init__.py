"""vipant_tpu_torch: the PyTorch + CUDA port of ``vipant_tpu`` for one NVIDIA
H100 (sm_90a).

The JAX package ``vipant_tpu`` stays the reference this port is checked
against. Plain tensor code here is PyTorch; each Pallas kernel of the JAX
package on a ported path becomes hand-written CUDA (``csrc/``), built with
``nvcc`` at first use (:mod:`vipant_tpu_torch.ops._build`). The port imports
``torch``, never ``jax``, and nothing of ``vipant_tpu``: it keeps its own
copies of the config composer with its YAML defaults (:mod:`.config`), the
BPE tokenizer (:mod:`.tokenizer`) and the registry (:mod:`.utils`).

Ported so far: the serving path (``serve.InferenceEngine``: audio, text and
image embeddings, zero-shot) of the CVAP and CLAP models, in bf16 and with
``quantize="int8"`` on forward-only int8 kernels; the VA training step
(``train.Trainer``: trainable/frozen split, LARS or Adam with clipping,
forward and backward through the kernels), optionally with the frozen image
tower on the int8 kernels (``model.image.int8_frozen``), and its epoch loop
(``Trainer.learn``: the host data layer of :mod:`.data`, pinned
host-to-device copies, retrieval eval, ``torch.save`` checkpoints, exact
resume), with the device frontend (the fbank and SpecAugment on the card
from shipped int16 waveforms, uint8 frames, int16 / bf16 fbanks); AT
fine-tuning (``LAMonitor``, ``python -m vipant_tpu_torch``); audio
captioning; serving from wav and image files, the HTTP server
(``serve.make_server``) and the serving command line (``python -m
vipant_tpu_torch.serve``).

Both entry points take ``device="cuda"`` by default and raise when there is
no CUDA device; ``device="cpu"`` runs the kernels' plain PyTorch versions::

    from vipant_tpu_torch.serve import InferenceEngine
    eng = InferenceEngine([...overrides...], batch_size=64, quantize="int8")

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q   # CPU parity tests
    python3 chip_smoke.py                                         # on the GPU
"""

__version__ = "0.1.0"
