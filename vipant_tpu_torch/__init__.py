"""vipant_tpu_torch: the PyTorch + CUDA port of ``vipant_tpu`` for one NVIDIA
H100 (sm_90a).

The JAX package ``vipant_tpu`` stays the reference this port is checked
against. Plain tensor code here is PyTorch; each Pallas kernel of the JAX
package on a ported path becomes hand-written CUDA (``csrc/``), built with
``nvcc`` at first use (:mod:`vipant_tpu_torch.ops._build`). The port shares
the JAX package's config (``vipant_tpu.config``) and tokenizer
(``vipant_tpu.tokenizer``), which import no JAX, and imports nothing else
of it.

Ported so far: the serving path (``serve.InferenceEngine``: audio, text and
image embeddings, zero-shot) of the CVAP and CLAP models, and the VA
training step (``train.Trainer``: trainable/frozen split, LARS or Adam with
clipping, forward and backward through the kernels) on device arrays.
"""

__version__ = "0.1.0"
