"""Host-side data pipeline of the port: index files, wav decode, host
fbank (native or NumPy), CLIP image preprocessing, the prefetching
loader, the VA datasets, the audio-text (Clotho, AudioCaps) datasets, the
x-fold classification sets (ESC-50, US8K, AudioSet eval, VoxCeleb2, JSONL),
the AudioSet datasets, the image-text (CLVP) dataset and the packed shards
(the port's own copies of
``vipant_tpu/data``'s NumPy/PIL modules; importing the originals pulls JAX
in).

Nothing here imports torch, so the loader's spawned worker processes start
without it; the step that places batches on the card is
:mod:`.device_put`, which the trainer imports.
"""

from .audio_text import build_audio_text_dataloader
from .audioset import build_audioset_dataloader, build_audioset_label_map
from .esc50 import build_xfold_dataloader_list
from .image_audio import build_image_audio_dataloader
from .image_text import build_image_text_dataloader
from .loader import DataLoader
from .wav import read_wav, write_wav

__all__ = ["DataLoader", "build_audio_text_dataloader", "build_audioset_dataloader",
           "build_audioset_label_map", "build_image_audio_dataloader", "build_image_text_dataloader",
           "build_xfold_dataloader_list",
           "read_wav", "write_wav"]
