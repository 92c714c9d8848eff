"""Host-side data pipeline of the port: index files, wav decode, host
fbank, CLIP image preprocessing, the prefetching loader, and the VA
datasets (the port's own copies of ``vipant_tpu/data``'s NumPy/PIL
modules; importing the originals pulls JAX in).

Nothing here imports torch, so the loader's spawned worker processes start
without it; the step that places batches on the card is
:mod:`.device_put`, which the trainer imports.
"""

from .image_audio import build_image_audio_dataloader
from .loader import DataLoader
from .wav import read_wav, write_wav

__all__ = ["DataLoader", "build_image_audio_dataloader", "read_wav", "write_wav"]
