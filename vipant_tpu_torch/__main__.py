"""Command line of the port: compose a config from overrides and run the
monitor it names, the counterpart of the repo root's ``train.py``:

    python -m vipant_tpu_torch +running=clotho +model/image=vit_val \
        +model/audio=vit_val +model/text=transformer_val +model/loss=ce \
        +optimizer=standard +running/audio=default worker=CLAP monitor=LAMonitor \
        running.data_root=/data/clotho eval=False

It runs on the card and raises when there is none; ``platform=cpu`` runs
the plain PyTorch versions on the CPU. ``blockprint=True`` sends standard
output to the null device (the log file stays). Training on a mesh runs one
process a rank under ``torchrun`` (each on ``cuda:{LOCAL_RANK}``, the group
over NCCL; gloo with ``platform=cpu``) or under the JAX launcher's
``NUM_PROCESSES`` / ``PROCESS_ID`` / ``COORDINATOR_ADDRESS``; ``mesh.model``,
``mesh.pipe`` or ``mesh.seq`` take their ranks and the data axis the rest::

    torchrun --nproc_per_node=8 -m vipant_tpu_torch <overrides> mesh.data=-1 [mesh.zero=true]
    torchrun --nproc_per_node=2 -m vipant_tpu_torch <overrides> mesh.model=2   # or mesh.pipe=2, mesh.seq=2
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    from .config import compose
    from .train import build_monitor

    cfg = compose(list(sys.argv[1:] if argv is None else argv))
    if bool(cfg.get("blockprint", False)):
        # the null device, not a buffer: the console log handler binds this
        # stream, and a buffer would grow for the whole run
        sys.stdout = open(os.devnull, "w")
    return build_monitor(cfg).learn()


if __name__ == "__main__":
    main()
