"""Offline CLIP model zoo: names, file resolution, sha256 verification.

The port's own copy of ``vipant_tpu/ckpt/zoo.py`` (the port imports nothing
of the JAX package; ``tests/test_torch_ckpt.py`` holds the ``_MODELS`` table
and the answers equal to the original's). The offline half of the
reference's zoo loader (`reference/clip/clip.py:18-57`): the name→artifact
table with the published sha256 digests, name→local-file resolution, and
checksum verification of an already-downloaded file. The download itself
is not implemented (no network): a missing file raises with the canonical
filename, so the user knows what to place under the root.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

# name -> (canonical filename, published sha256) — digests are the path
# component of the reference's download URLs (`reference/clip/clip.py:18-25`)
_MODELS = {
    "RN50": ("RN50.pt", "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762"),
    "RN101": ("RN101.pt", "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599"),
    "RN50x4": ("RN50x4.pt", "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd"),
    "RN50x16": ("RN50x16.pt", "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa"),
    "ViT-B32": ("ViT-B-32.pt", "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af"),
    "ViT-B16": ("ViT-B-16.pt", "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f"),
}


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def verify_sha256(path: str, expected: str) -> bool:
    return sha256_file(path) == expected


def resolve(name: str, root: str, verify: bool = True) -> Optional[str]:
    """Zoo name → verified local file path under ``root``.

    Returns None when ``name`` is not a zoo name. Raises FileNotFoundError
    when the name is known but the artifact is absent (naming the expected
    file), and RuntimeError on checksum mismatch — the reference would
    re-download (`reference/clip/clip.py:38-42`); offline, a corrupt
    explicitly-requested artifact must not silently load.
    """
    entry: Optional[Tuple[str, str]] = _MODELS.get(name)
    if entry is None:
        return None
    filename, digest = entry
    candidates = [os.path.join(root, filename), os.path.join(root, f"{name}.pt")]
    path = next((p for p in candidates if os.path.isfile(p)), None)
    if path is None:
        raise FileNotFoundError(
            f"CLIP model {name!r} not found under {root!r}; place the "
            f"downloaded artifact there as {filename!r} (sha256 {digest})"
        )
    if verify and not verify_sha256(path, digest):
        raise RuntimeError(
            f"{path} exists but its SHA256 does not match the published "
            f"digest for {name!r} ({digest}); re-download the artifact"
        )
    return path
