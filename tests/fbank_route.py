"""The host fbank's route, pinned alike in both packages for the parity tests.

Both packages send a host featurisation (``host_fbank`` of their
``data/transforms_audio.py``) to their C++ fbank when its library is built
and to the NumPy fbank otherwise; the port builds its library at first use
wherever a C++ compiler is found. The two routes agree to ~4e-4, not
bitwise, so a test that holds the port's items or features to the JAX
package's pins both packages to the NumPy fbank:

- :func:`pin_numpy_fbank` in this process (through a ``pytest.MonkeyPatch``
  when given one, undone with it);
- :func:`pin_workers` in the loader's spawned worker processes, which a
  monkeypatch does not reach: it swaps each loader's dataset for a subclass
  whose ``__setstate__`` (run when a worker unpickles the dataset, before any
  item) pins the worker's process.

The native route itself is held to NumPy and to the JAX package's library in
``tests/test_torch_native.py``.
"""

import vipant_tpu.data.transforms_audio as jax_transforms_audio
from vipant_tpu.data import image_audio as jax_image_audio
import vipant_tpu_torch.data.transforms_audio as port_transforms_audio
from vipant_tpu_torch.data import image_audio as port_image_audio


def pin_numpy_fbank(mp=None) -> None:
    """Both packages' ``host_fbank`` -> their NumPy fbank: through ``mp``, or
    for the life of the process without one (a worker)."""
    pins = ((jax_transforms_audio, jax_transforms_audio._fbank_np),
            (port_transforms_audio, port_transforms_audio.fbank_np))
    for module, fbank in pins:
        if mp is None:
            module.host_fbank = fbank
        else:
            mp.setattr(module, "host_fbank", fbank)


class _PinsInWorkers:
    def __setstate__(self, state):
        self.__dict__.update(state)
        pin_numpy_fbank()


class JaxSrcNumpyFbank(_PinsInWorkers, jax_image_audio.ImageAudioDatasetSrc):
    """The JAX package's wav dataset, on the NumPy fbank in its workers too."""


class PortSrcNumpyFbank(_PinsInWorkers, port_image_audio.ImageAudioDatasetSrc):
    """The port's wav dataset, on the NumPy fbank in its workers too."""


_PINNED = {jax_image_audio.ImageAudioDatasetSrc: JaxSrcNumpyFbank,
           port_image_audio.ImageAudioDatasetSrc: PortSrcNumpyFbank}


def pin_workers(*loaders) -> None:
    """Each loader's wav dataset -> its subclass that pins its workers."""
    for loader in loaders:
        loader.dataset.__class__ = _PINNED[type(loader.dataset)]
