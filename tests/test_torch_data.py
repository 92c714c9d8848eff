"""The port's data layer (vipant_tpu_torch/data, ops/fbank_np.py,
ops/mel.py, eval/metrics.py, utils) against the JAX package's originals.

The port keeps its own copies of the NumPy/PIL modules (importing the
originals pulls JAX in). Where a copy is the same code, its definitions are
held equal to the original's with the docstrings left out (the copies'
docstrings name the port, not the reference's paths); where it is not, its
behaviour is held equal on seeded inputs:

- the loaders give byte-identical batches over two epochs on the synthetic
  index of ``tests/data_synth.py``: the wav source with SpecAugment on, on
  the ``process`` backend (per-item seeds) and on ``thread`` with one
  worker; the npz source; the eval loader with ``pad_last`` / ``_count``;
  ``set_epoch(start_batch=)``. Each package's fbank goes through its C++
  frontend when that is built, which agrees with the NumPy fbank to ~4e-4,
  not bitwise: both sides run on their NumPy fbank here, in their worker
  processes too (``tests/fbank_route.py``);
- the two host-layer faults the copy fixes are the named differences, each
  tested on its own: ``eval_sample_limit`` raises on a value that is not a
  number, and ``shard_for_host`` pads training shards only;
- the fbank, mel banks and metrics equal the originals' bitwise.
"""

import ast
import importlib
import inspect
import os

import numpy as np
import pytest
import torch

import vipant_tpu.data.transforms_audio as jax_transforms_audio
from vipant_tpu.config import compose as jax_compose
from vipant_tpu.data import build_image_audio_dataloader as jax_build_loader
from vipant_tpu.data import image_audio as jax_image_audio
from vipant_tpu.data import indexfile as jax_indexfile
from vipant_tpu.data import loader as jax_loader
from vipant_tpu.data import transforms_image as jax_transforms_image
from vipant_tpu.data import wav as jax_wav
from vipant_tpu.eval import metrics as jax_metrics
from vipant_tpu.ops import mel as jax_mel
from vipant_tpu import utils as jax_utils
from vipant_tpu.utils import hostmem as jax_hostmem
from vipant_tpu_torch import eval as port_eval
from vipant_tpu_torch import utils as port_utils
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.data import build_image_audio_dataloader, device_put, image_audio, indexfile
from vipant_tpu_torch.data import loader as port_loader
from vipant_tpu_torch.data import transforms_audio, transforms_image, wav
from vipant_tpu_torch.eval import metrics
from vipant_tpu_torch.ops import fbank_np, mel
from vipant_tpu_torch.utils import hostmem

from data_synth import make_synth_va_index, make_synth_va_npz_index
from fbank_route import pin_numpy_fbank, pin_workers

# the module: `vipant_tpu.ops` exports its function `fbank` under this name
jax_fbank_np = importlib.import_module("vipant_tpu.ops.fbank_np")

BASE = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "running.audio.max_len=100", "running.batch_size=3", "seed=5",
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("va"))
    make_synth_va_index(d, "train", n=7, seconds=1.05)
    make_synth_va_index(d, "val", n=5, seconds=1.05)
    make_synth_va_npz_index(d, "npz_train", n=7)
    return d


def _overrides(root, *extra):
    return BASE + [f"running.data_root={root}", *extra]


def _epochs(loader, epochs=2, start_batch=0, reseed=None):
    out = []
    for e in range(epochs):
        if reseed is not None:
            np.random.seed(reseed + e)
        loader.set_epoch(e, start_batch=start_batch if e == 0 else 0)
        out.extend(loader)
    loader.shutdown()
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["name"] == w["name"] and g.get("_count") == w.get("_count")
        for k in ("image", "audio"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


def _loaders(root, data_name, train, *extra, pin=False):
    """The port's loader and the JAX package's; ``pin``: both on their NumPy
    fbank in their worker processes too."""
    over = _overrides(root, *extra)
    got = build_image_audio_dataloader(compose(over), data_name, train)
    want = jax_build_loader(jax_compose(over), data_name, train)
    if pin:
        pin_workers(got, want)
    return got, want


@pytest.mark.parametrize("backend,workers", [("process", 2), ("thread", 1)])
def test_wav_loader_gives_the_jax_batches(root, backend, workers, monkeypatch):
    pin_numpy_fbank(monkeypatch)
    got, want = _loaders(root, "train", True, f"loader_backend={backend}", f"num_proc={workers}",
                         pin=True)
    assert got.dataset.transform_fbank and len(got) == 2  # SpecAugment on; 7 items, drop_last
    reseed = 11 if backend == "thread" else None  # the thread backend shares np.random
    g, w = _epochs(got, reseed=reseed), _epochs(want, reseed=reseed)
    _same_batches(g, w)
    assert g[0]["name"] != g[2]["name"]  # each epoch its own order
    assert not np.array_equal(g[0]["audio"], g[2]["audio"])


def test_npz_loader_gives_the_jax_batches(root):
    got, want = _loaders(root, "npz_train", True, "loader_backend=process", "num_proc=2")
    assert isinstance(got.dataset, image_audio.ImageAudioDatasetNpz)
    _same_batches(_epochs(got), _epochs(want))


def test_eval_loader_pads_the_last_batch_as_the_jax_one(root, monkeypatch):
    pin_numpy_fbank(monkeypatch)
    got, want = _loaders(root, "val", False, "loader_backend=thread", "num_proc=2")
    g, w = _epochs(got, epochs=1), _epochs(want, epochs=1)
    _same_batches(g, w)
    assert [b["_count"] for b in g] == [3, 2] and g[1]["name"][2] == g[1]["name"][1]


def test_set_epoch_start_batch_resumes_the_jax_order(root):
    got, want = _loaders(root, "train", True, "loader_backend=process", "num_proc=2",
                         "running.batch_size=2", pin=True)
    g, w = _epochs(got, start_batch=2), _epochs(want, start_batch=2)
    _same_batches(g, w)
    full = _epochs(got)  # the skipped batches are skipped, the rest replayed exactly
    _same_batches(g, full[2:])


def test_pinned_device_put_on_the_cpu_hands_the_batch_over(root):
    put = device_put.PinnedDevicePut(("image", "audio"), device="cpu")
    got = build_image_audio_dataloader(compose(_overrides(root, "num_proc=1")), "val", False,
                                       device_put_fn=put)
    want = build_image_audio_dataloader(compose(_overrides(root, "num_proc=1")), "val", False)
    for g, w in zip(_epochs(got, 1), _epochs(want, 1)):
        images, audios = put.wait(g)
        assert images.device.type == "cpu" and images.dtype == torch.float32
        assert np.array_equal(images.numpy(), w["image"]) and np.array_equal(audios.numpy(), w["audio"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_put.PinnedDevicePut(("image", "audio"))  # the card by default; there is none here


def test_a_worker_that_dies_raises(root):
    loader = build_image_audio_dataloader(
        compose(_overrides(root, "loader_backend=process", "num_proc=1")), "val", False)
    loader.dataset = _Dies(loader.dataset)
    with pytest.raises(Exception, match="terminated abruptly"):
        list(loader)
    loader.shutdown()


class _Dies:
    """A dataset whose item kills the worker process that reads it."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        os._exit(3)


def test_workers_hide_the_gpus(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(port_loader, "_WORKER_DATASET", None)
    port_loader._worker_init([1], 0)  # what a spawned worker runs first
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "" and port_loader._WORKER_DATASET == [1]


@pytest.mark.parametrize("extra,item,name", [
    # the siamese dataset (ported) refuses what the device fbank does not compute, as the others do
    pytest.param(["running.multi_view=True", "running.audio.on_device=True",
                  "running.audio.dither=1.0"], "dither", "train", id="extra0-A12"),
    pytest.param(["running.audio.on_device=True", "running.audio.dither=1.0"], "dither", "train",
                 id="extra1-dither"),
    pytest.param(["running.audio.on_device=True", "running.audio.use_energy=True"], "use_energy",
                 "train", id="extra2-use_energy"),
    # so does a packed dataset (ported), before it opens its pack
    pytest.param(["running.audio.on_device=True", "running.audio.use_energy=True"], "use_energy",
                 "pak_train", id="extra3-A11-rest"),
])
def test_unported_data_options_are_refused(root, extra, item, name):
    with pytest.raises(NotImplementedError, match=item):
        build_image_audio_dataloader(compose(_overrides(root, *extra)), name, True)


@pytest.mark.parametrize("extra,name,flag", [
    (["running.audio.on_device=True"], "train", "on_device"),
    (["running.image_uint8=True"], "train", "image_uint8"),
    (["running.audio.ship_int16=True"], "npz_train", None),
    (["running.audio.ship_bf16=True"], "npz_train", None),
])
def test_the_shipping_formats_are_accepted(root, extra, name, flag):
    """The device frontend's formats (ported after A8; their parity tests:
    tests/test_torch_frontend.py)."""
    loader = build_image_audio_dataloader(compose(_overrides(root, *extra)), name, True)
    assert flag is None or getattr(loader.dataset, flag)


# ------------------------------------------------------------ the two fixes
@pytest.mark.parametrize("value", [None, 0, -3, "inf", float("inf"), 25, "25", 25.9, "1e3"])
def test_eval_sample_limit_equals_the_jax_one_on_numbers(value):
    assert indexfile.eval_sample_limit(value) == jax_indexfile.eval_sample_limit(value)


@pytest.mark.parametrize("typo", ["25O", "all", [25]])
def test_eval_sample_limit_raises_on_a_typo_where_the_jax_one_evaluates_everything(typo):
    assert jax_indexfile.eval_sample_limit(typo) is None
    with pytest.raises(ValueError, match="must be a number"):
        indexfile.eval_sample_limit(typo)


@pytest.mark.parametrize("n,hosts", [(7, 2), (5, 3), (2, 4), (8, 4)])
def test_shard_for_host_pads_training_shards_only(n, hosts):
    records = list(range(n))
    for pid in range(hosts):
        assert indexfile.shard_for_host(records, pid, hosts, True) == \
            jax_indexfile.shard_for_host(records, pid, hosts)
    evals = [indexfile.shard_for_host(records, pid, hosts, False) for pid in range(hosts)]
    assert sorted(sum(evals, [])) == records  # every record once: no wrapped duplicate
    padded = sum((jax_indexfile.shard_for_host(records, pid, hosts) for pid in range(hosts)), [])
    assert len(padded) == -(-n // hosts) * hosts  # the JAX package's eval shards repeat records


# ------------------------------------------------------- the copies in step
def _defs(module, names=None):
    """name -> AST dump of each top-level definition, docstrings left out."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            out[ast.unparse(node.targets[0])] = ast.dump(node)
    return out if names is None else {k: out[k] for k in names}


# what a copy writes anew on purpose; its behaviour is held to the original's
# elsewhere: the metrics' multilabel report without scikit-learn, which the
# card's machine lacks (tests/test_torch_classify.py)
REWRITTEN = {metrics.__name__: ("multilabel_report", "_binary_clf_curve", "precision_recall_curve",
                                "_binary_average_precision", "average_precision_score",
                                "roc_auc_score")}


@pytest.mark.parametrize("port,orig", [
    (mel, jax_mel), (fbank_np, jax_fbank_np), (wav, jax_wav), (hostmem, jax_hostmem),
    (metrics, jax_metrics), (port_eval, importlib.import_module("vipant_tpu.eval")),
], ids=["mel", "fbank_np", "wav", "hostmem", "metrics", "eval"])
def test_verbatim_copies_are_the_same_code(port, orig):
    rewritten = REWRITTEN.get(port.__name__, ())
    got = {k: v for k, v in _defs(port).items() if k not in rewritten}
    want = {k: v for k, v in _defs(orig).items() if k not in rewritten}
    assert got == want
    strip = lambda m: [ast.dump(n) for n in ast.parse(inspect.getsource(m)).body
                       if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert strip(port) == strip(orig)


@pytest.mark.parametrize("port,orig,names", [
    (port_utils, jax_utils, ["setup_logger", "AverageMeter", "PhaseTimer"]),
    (indexfile, jax_indexfile, ["load_jsonl", "load_csv", "resolve_media_path", "epoch_permutation"]),
    (transforms_audio, jax_transforms_audio,
     ["random_crop", "RandomFlip", "RandomScale", "RandomCrop", "RandomPad", "RandomNoise",
      "SimpleRandomNoise", "FrequencyMasking", "TimeMasking", "_TRANSFORMS", "make_transform",
      "extract_fbank_features"]),
    (transforms_image, jax_transforms_image, ["CLIP_MEAN", "CLIP_STD"]),
    (image_audio, jax_image_audio, ["fbank_params_from_cfg"]),
    # the packed datasets' batch task; _worker_getitem also seeds ``random`` (below)
    (port_loader, jax_loader, ["_worker_getbatch"]),
], ids=["utils", "indexfile", "transforms_audio", "transforms_image", "image_audio", "loader"])
def test_copied_definitions_are_the_same_code(port, orig, names):
    assert _defs(port, names) == _defs(orig, names)


def test_worker_getitem_seeds_numpy_as_the_jax_loader_and_random_too(monkeypatch):
    """An item task seeds NumPy with its seed, as the JAX loader does, and
    Python's ``random`` with it too (the siamese image views draw from it;
    the JAX loader leaves it unseeded: ROADMAP.md C14)."""
    import random

    draw = lambda: (np.random.rand(), random.random())
    for mod in (port_loader, jax_loader):
        monkeypatch.setattr(mod, "_WORKER_DATASET", type("D", (), {"__getitem__": lambda self, i: draw()})())
    random.seed(99)
    got = port_loader._worker_getitem(3, 1234)
    random.seed(99)
    want = jax_loader._worker_getitem(3, 1234)
    np.random.seed(1234)
    random.seed(1234)
    assert got == (np.random.rand(), random.random())
    assert got[0] == want[0] and got[1] != want[1]


def test_changed_definitions_behave_as_the_originals():
    from PIL import Image

    img = Image.fromarray((np.random.default_rng(0).random((61, 90, 3)) * 255).astype(np.uint8))
    assert np.array_equal(transforms_image.clip_preprocess(img, 32),
                          jax_transforms_image.clip_preprocess(img, 32))
    for fn in (port_utils.seed_all_rng, jax_utils.seed_all_rng):
        fn(7)
        assert np.random.rand() == pytest.approx(np.random.RandomState(7).rand(), abs=0)
    ts = {"a": torch.zeros(3, 4), "b": torch.zeros(5)}
    ts["c"] = ts["a"]
    assert port_utils.numel(ts) == jax_utils.numel({k: np.zeros(v.shape) for k, v in ts.items()
                                                    if k != "c"}) == 17


# ------------------------------------------------------------ copy parity
@pytest.mark.parametrize("n", [400, 16800, 160400])
def test_fbank_equals_the_jax_package_s(n):
    x = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
    params = fbank_np.FbankParams(window_type="hamming" if n == 400 else "hanning")
    got = fbank_np.fbank(x, params)
    want = jax_fbank_np.fbank(x, jax_fbank_np.FbankParams(**params.__dict__))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.array_equal(mel.mel_banks(64, 512, 16000.0), jax_mel.mel_banks(64, 512, 16000.0))


def test_metrics_equal_the_jax_package_s():
    r = np.random.default_rng(3)
    a, b = r.standard_normal((12, 8)), r.standard_normal((12, 8))
    sym = metrics.symmetric_retrieval(a, b)
    assert sym == jax_metrics.symmetric_retrieval(a, b)
    assert metrics.format_retrieval_report(sym, 12) == jax_metrics.format_retrieval_report(sym, 12)
    names = [f"s{i}" for i in range(12)]
    cls = {n: f"c{i % 3}" for i, n in enumerate(names)}
    by = {}
    for n, c in cls.items():
        by.setdefault(c, []).append(n)
    order = np.argsort(-(a @ b.T), axis=1)
    assert metrics.grouped_pnr(order, names, cls, by) == jax_metrics.grouped_pnr(order, names, cls, by)
    cands = ["a dog barks loudly", "rain falls on the roof", "a car passes by"]
    refs = [["a dog is barking", "dog barks"], ["rain on a roof"], ["cars pass by quickly"]]
    for fn in ("corpus_bleu", "rouge_l", "cider_d", "meteor"):
        assert getattr(metrics, fn)(cands, refs) == getattr(jax_metrics, fn)(cands, refs), fn
