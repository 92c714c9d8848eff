"""Rank workers of the port's data-parallel CPU tests (imports no JAX).

:func:`run_ranks` starts ``world`` processes of this file, each one rank of
a gloo group that meets through a ``FileStore`` in the test's directory (no
TCP port to race for between test workers), with one torch thread and a
time limit: a rank that fails, or outlives its limit, fails the test. Each
rank runs one case of :data:`CASES` on the spec the parent wrote and saves
what it found for the parent to compare::

    python tests/torch_dist_worker.py <case> <rank> <world> <dir>
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "NUM_PROCESSES",
              "PROCESS_ID", "COORDINATOR_ADDRESS")


def one_rank(overrides):
    """A port config from overrides shared with the JAX side, for one process
    without a launcher: the JAX side lays its tests' tiny batches over
    ``mesh.data=2`` of its 8 CPU devices, while the port runs one process a
    rank, so its ``mesh.data`` is the world size (-1)."""
    return [*overrides, "mesh.data=-1"]


def run_ranks(directory, case: str, spec: dict, world: int = 2, timeout: float = 180.0) -> list:
    """Run ``case`` on ``world`` ranks with ``spec``; each rank's result."""
    d = os.path.join(str(directory), f"ranks_{case}_{time.monotonic_ns()}")
    os.makedirs(d)
    torch.save(spec, os.path.join(d, "spec.pt"))
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, HERE, env.get("PYTHONPATH", "")]))
    logs = [open(os.path.join(d, f"log{r}.txt"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), d], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=d)
             for r in range(world)]
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()

    def tail(r):
        with open(os.path.join(d, f"log{r}.txt")) as f:
            return f.read()[-3000:]

    if late:
        raise AssertionError(f"{case}: rank(s) {late} ran past {timeout} s:\n" + tail(late[0]))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{case}: rank {bad[0]} exited {procs[bad[0]].returncode}:\n"
                             + tail(bad[0]))
    return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ cases
def _numpy(tensors):
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


def _trainer(spec, *extra, **kw):
    from vipant_tpu_torch.ckpt import from_jax
    from vipant_tpu_torch.train import build_monitor

    tr = build_monitor(list(spec["overrides"]) + list(extra), device="cpu", **kw)
    if spec.get("params") is not None:
        from_jax.load_params(tr.model, spec["params"], tr.placement)
    if spec.get("stats") is not None:
        from_jax.load_batch_stats(tr.model, spec["stats"])
    return tr


def steps(spec, rank, world):
    """``spec["steps"]`` training steps through ``Trainer.train_step`` on this
    rank's rows of ``spec["args"]``: each step's loss, grad norm, params and
    running statistics, and the first step's grads as the optimizer got
    them (averaged over the ranks)."""
    from vipant_tpu_torch.parallel import shard_batch

    tr = _trainer(spec, steps_per_epoch=spec.get("spe", 10))
    if spec.get("patchout") is not None:  # the index sets to take, in order
        queue = [np.asarray(i) for i in spec["patchout"]]
        tr.model.audio.patchout_indices = lambda n, keep, device: torch.as_tensor(queue.pop(0))
    seen = []
    apply = tr.state.optimizer.apply
    tr.state.optimizer.apply = lambda g: (seen.append(_numpy(g)), apply(g))[1]
    args = tr.make_batch(*shard_batch(list(spec["args"]), tr.mesh))
    out = []
    for _ in range(int(spec.get("steps", 2))):
        m = tr.train_step(*args)
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        params=_numpy(tr.trainable), stats=_numpy(dict(tr.model.named_buffers())),
                        generator=tr.state.generator.get_state()))
    return {"steps": out, "grads": seen[0], "mesh": (tr.mesh.rank, tr.mesh.data, tr.mesh.backend),
            "grad_cache": tr.grad_cache}


def zero(spec, rank, world):
    """Three steps with ZeRO and without from one init and batch, a save
    after the first step of each, and each save resumed by a run of the
    other kind for its last two steps."""
    from vipant_tpu_torch.parallel import shard_batch
    from vipant_tpu_torch.parallel.zero import ZeroOptimizer

    root = spec["root"]
    out = {}
    for z in (False, True):
        run = os.path.join(root, f"zero_{z}")
        tr = _trainer(spec, f"mesh.zero={z}", f"alias_root={run}", steps_per_epoch=10)
        assert isinstance(tr.state.optimizer, ZeroOptimizer) == z
        args = tr.make_batch(*shard_batch(list(spec["args"]), tr.mesh))
        for i in range(3):
            tr.train_step(*args)
            tr.global_step += 1
            if i == 0:
                saved = tr.save()
        out[z] = dict(params=_numpy(tr.trainable), opt=tr.state.optimizer.state_dict(),
                      bytes=tr.state.optimizer.state_bytes(), saved=saved, args=args)
    for z in (False, True):  # resume the other kind's save
        tr = _trainer({**spec, "params": None}, f"mesh.zero={z}",
                      f"model_root={os.path.dirname(os.path.dirname(out[not z]['saved']))}",
                      f"model_file={os.path.basename(out[not z]['saved'])}",
                      f"alias_root={os.path.join(root, f'resume_{z}')}", steps_per_epoch=10)
        assert tr.global_step == 1
        for _ in range(2):
            tr.train_step(*out[z]["args"])
        out[z]["resumed"] = _numpy(tr.trainable)
        out[z]["resumed_opt"] = tr.state.optimizer.state_dict()
    for z in (False, True):
        del out[z]["args"]
    return out


def loop(spec, rank, world):
    """``Trainer.learn`` over the synthetic index with its saves and evals
    (each eval's report recorded), then a run resumed from the first save:
    the last params of both."""
    reports = []

    def learn(*extra):
        tr = _trainer(spec, *extra)
        infer = tr.infer
        tr.infer = lambda *a, **k: (lambda r: (reports.append((tr.global_step, r)), r)[1])(
            infer(*a, **k))
        tr.learn()
        return tr

    tr = learn(f"alias_root={spec['root']}/a")
    first = sorted(d for d in os.listdir(tr.out_dir) if d.isdigit())[0]
    out = dict(reports=list(reports), params=_numpy(tr.trainable), step=tr.global_step,
               first=os.path.join(tr.out_dir, first), buffers=_numpy(dict(tr.model.named_buffers())),
               logs=sorted(os.listdir(tr.out_dir)))
    reports.clear()
    re = learn(f"alias_root={spec['root']}/b", f"model_root={spec['root']}/a",
               f"model_file={first}")
    out.update(resumed=_numpy(re.trainable), resumed_step=re.global_step)
    return out


def rn_tower(spec, rank, world):
    """A ResNet tower in float64, in train mode, on this rank's rows with its
    BatchNorms on the data mesh: its output, the sum over the ranks of each
    param's grad of ``sum(out * cot)`` over this rank's rows (the JAX grad of
    the whole batch's sum), and the moved statistics."""
    from vipant_tpu_torch.ckpt import from_jax
    from vipant_tpu_torch.nn.resnet import ResNetTower
    from vipant_tpu_torch.parallel import all_reduce_sum, attach, gather_batch, make_mesh

    mesh = make_mesh(device="cpu")
    tower = ResNetTower(resolution=spec["resolution"], dtype=torch.float64, **spec["kw"])
    sd = {k: torch.tensor(v) for k, v in from_jax.tower_state_dict(spec["params"]).items()}
    sd.update({k.split(".", 1)[1]: torch.tensor(v) for k, v in
               from_jax.batch_stats_state_dict({"image": spec["stats"]}).items()})
    tower.load_state_dict(sd, strict=True)
    tower.double()
    attach(tower, mesh)
    b = spec["x"].shape[0] // world
    x = torch.tensor(spec["x"][rank * b:(rank + 1) * b], dtype=torch.float64)
    out = tower(x, train=True)
    (out * torch.tensor(spec["cot"][rank * b:(rank + 1) * b])).sum().backward()
    return dict(out=gather_batch(out.detach(), mesh).numpy(),
                grads={k: all_reduce_sum(p.grad, mesh).numpy() for k, p in tower.named_parameters()},
                stats={k: v.numpy().copy() for k, v in tower.named_buffers()})


def _full(tr, tensors, names=None):
    """The full tensors of a trainer split over the model or pipe axis (a
    collective: every rank calls it)."""
    return _numpy(tr.placement.full(dict(tensors), names or tr.full_names[0]))


def mesh_steps(spec, rank, world):
    """``spec["steps"]`` training steps through ``Trainer.train_step`` on a
    mesh of the overrides' axes, each rank on its data shard's rows: each
    step's loss and grad norm and the full params, the first step's full
    grads as the optimizer got them, the mesh's coordinates, and with
    ``spec["save"]`` a save after the first step resumed by a second
    trainer (on the same mesh, or on one rank with ``spec["resume_over"]``)
    for the remaining steps."""
    from vipant_tpu_torch.parallel import shard_batch

    tr = _trainer(spec, steps_per_epoch=spec.get("spe", 10), *spec.get("extra", ()))
    seen = []
    apply = tr.state.optimizer.apply
    tr.state.optimizer.apply = lambda g: (seen.append(dict(g)), apply(g))[1]
    args = tr.make_batch(*shard_batch(list(spec["args"]), tr.mesh))
    out, saved = [], None
    for i in range(int(spec.get("steps", 2))):
        m = tr.train_step(*args)
        tr.global_step += 1
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        params=_full(tr, tr.trainable)))
        if i == 0 and spec.get("save"):
            saved, at = tr.save(), tr.global_step
    res = {"steps": out, "grads": _full(tr, seen[0]), "coords": dict(tr.mesh.coords),
           "shape": tr.mesh.shape, "local": {k: tuple(v.shape) for k, v in tr.trainable.items()},
           "splits": {k: (v.axis, v.rule) for k, v in tr.placement.splits.items()}}
    if saved:
        re = _trainer({**spec, "params": None}, f"alias_root={spec['root']}/resumed{rank}",
                      f"model_root={os.path.dirname(os.path.dirname(saved))}",
                      f"model_file={os.path.basename(saved)}", *spec.get("extra", ()),
                      steps_per_epoch=spec.get("spe", 10))
        assert re.global_step == at
        for _ in range(int(spec.get("steps", 2)) - 1):
            re.train_step(*args)
        res["resumed"] = _full(re, re.trainable)
        res["saved"] = saved
    return res


def _mesh(**axes):
    from vipant_tpu_torch.parallel import make_mesh

    return make_mesh(device="cpu", **axes)


def tp_blocks(spec, rank, world):
    """The sub-blocks on a model axis of ``world``: each case's full torch
    weights sliced by the port's rule, the op run on this rank's slices
    with ``tp``, its output and the full grads of ``sum(out * cot)``
    (slices gathered over the model group)."""
    from vipant_tpu_torch.ops import fused_attn, fused_mlp
    from vipant_tpu_torch.parallel import tensor

    mesh = _mesh(model=world)
    rules = {"wqkv": "qkv", "bqkv": "qkv", "wout": "cols", "wfc": "rows", "bfc": "rows",
             "wproj": "cols"}
    out = {}
    for name, case in spec["cases"].items():
        dt = getattr(torch, case.get("dtype", "float32"))
        full = {k: torch.tensor(v) for k, v in case["w"].items()}
        w = {k: (tensor._blocks(v, rules[k], world)[mesh.index("model")].contiguous()
                 if k in rules else v).requires_grad_(True) for k, v in full.items()}
        x = torch.tensor(case["x"]).to(dt).requires_grad_(case["kind"].find("int8") < 0)
        bias = torch.tensor(case["bias"]) if case.get("bias") is not None else None
        heads = case["heads"] // world
        kind = case["kind"]
        if kind in ("attn", "ln_attn", "ln_attn_int8"):
            args = (w["wqkv"], w["bqkv"], w["wout"], w["bout"])
            if kind == "attn":
                y = fused_attn.fused_attention_block(x, *args, bias=bias, heads=heads, tp=mesh)
            elif kind == "ln_attn":
                y = fused_attn.fused_ln_attention_block(x, w["lns"], w["lnb"], *args, bias=bias,
                                                        heads=heads, tp=mesh)
            else:
                with torch.no_grad():
                    y = fused_attn.fused_ln_attention_block_int8(x, w["lns"], w["lnb"], *args,
                                                                 bias=bias, heads=heads, tp=mesh)
        else:
            args = (x, w["lns"], w["lnb"], w["wfc"], w["bfc"], w["wproj"], w["bproj"])
            if kind == "mlp":
                y = fused_mlp.fused_ln_mlp_block(*args, act=case["act"], tp=mesh)
            else:
                with torch.no_grad():
                    y = fused_mlp.fused_ln_mlp_block_int8(*args, act=case["act"], tp=mesh)
        res = {"out": y.detach().float().numpy()}
        if y.requires_grad:
            (y.float() * torch.tensor(case["cot"])).sum().backward()
            res["grads"] = {"x": x.grad.float().numpy()}
            for k, v in w.items():
                g = v.grad
                if k in rules:
                    parts = tensor._all_gather(g.contiguous()[None], mesh, "model")
                    g = tensor._join(list(parts), rules[k])
                res["grads"][k] = g.float().numpy()
        out[name] = res
    return out


def ring_ops(spec, rank, world):
    """``ring_attention`` over a seq ring of ``world``: each case's full q,
    k, v [B, T, H, D] split by tokens, the mask by query rows; the output
    and (fp32 cases) the grads of ``sum(out * w)``, gathered along the
    tokens."""
    from vipant_tpu_torch.parallel import sequence

    mesh = _mesh(seq=world)
    i = mesh.index("seq")
    out = {}
    for name, case in spec["cases"].items():
        dt = getattr(torch, case.get("dtype", "float32"))
        T = case["q"].shape[1]
        Tl = T // world
        q, k, v = (torch.tensor(case[n][:, i * Tl:(i + 1) * Tl]).to(dt).requires_grad_(True)
                   for n in ("q", "k", "v"))
        bias = case.get("bias")
        bias = None if bias is None else torch.tensor(bias[i * Tl:(i + 1) * Tl])
        y = sequence.ring_attention(q, k, v, mesh, bias)
        res = {"out": sequence.gather_tokens(y.detach().float(), mesh).numpy(), "dtype": str(y.dtype)}
        if case.get("grads", True):
            (y.float() * torch.tensor(case["w"][:, i * Tl:(i + 1) * Tl])).sum().backward()
            res["grads"] = [sequence.gather_tokens(t.grad, mesh).numpy() for t in (q, k, v)]
        out[name] = res
    return out


def seq_trunk(spec, rank, world):
    """A stacked ``Transformer`` (the JAX ``StackedTransformer``'s params) on a
    seq ring of ``world``: its output and its params' grads of ``sum(out **
    2)`` (each rank's summed over the ring, as the step sums them)."""
    from vipant_tpu_torch.nn.layers import Transformer
    from vipant_tpu_torch.parallel import attach
    from vipant_tpu_torch.parallel.collectives import _all_reduce_

    mesh = _mesh(seq=world)
    C, L, H = spec["width"], spec["layers"], spec["heads"]
    out = {}
    for name, case in spec["cases"].items():
        tr = Transformer(C, L, H)
        tr.load_state_dict({k: torch.tensor(v) for k, v in spec["params"].items()})
        tr.stacked = True
        attach(tr, mesh)
        x = torch.tensor(case["x"])
        bias = None if case.get("bias") is None else torch.tensor(case["bias"])
        y = tr(x, bias)
        (y ** 2).sum().backward()
        out[name] = {"out": y.detach().numpy(), "rang": tr.rang,
                     "grads": {k: _all_reduce_(p.grad.clone(), mesh, "seq").numpy()
                               for k, p in tr.named_parameters()}}
    return out


def mp_engine(spec, rank, world):
    """``InferenceEngine(model_parallel=world)`` on every rank from the same
    full weights: each entry point's result, and with ``spec["server"]``
    rank 0's HTTP server answering one request of each route while the
    other ranks follow it (:meth:`InferenceEngine.follow`)."""
    import json
    import threading
    import urllib.request

    from vipant_tpu_torch.ckpt import from_jax
    from vipant_tpu_torch.serve import InferenceEngine, make_server

    out = {}
    for label, e in spec["engines"].items():
        eng = InferenceEngine(e["cfg"], batch_size=e.get("batch_size", 4), device="cpu",
                              model_parallel=world, quantize=e.get("quantize", ""))
        if e.get("params") is not None:
            from_jax.load_params(eng.model, e["params"], eng.placement)
        res = {"splits": sorted(eng.placement.splits)}
        if "fb" in e:
            res["audio"] = eng.embed_audio(e["fb"])
        if "texts" in e:
            res["texts"] = eng.embed_texts(e["texts"], prompt="the sound of ")
        if "classes" in e:
            res["zero_shot"] = eng.zero_shot(e["fb"], e["classes"])["scores"]
        if "caption" in e:
            res["caption"] = eng.caption(e["caption"])
        if e.get("server"):
            if rank == 0:
                srv = make_server(eng, port=0)
                t = threading.Thread(target=srv.serve_forever, daemon=True)
                t.start()
                url = f"http://127.0.0.1:{srv.server_address[1]}/embed_text"
                req = urllib.request.Request(url, data=json.dumps({"texts": e["texts"],
                                                                "prompt": "the sound of "}).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    res["http"] = np.asarray(json.loads(r.read())["embeddings"], np.float32)
                srv.shutdown()
                srv.server_close()
                eng.stop_followers()
            else:
                res["followed"] = eng.follow()
        out[label] = res
    return out


def multi(spec, rank, world):
    """Several cases in one group of processes, in order: ``spec["runs"]``
    maps a label to ``(case, its spec)``."""
    return {label: CASES[case](sub, rank, world) for label, (case, sub) in spec["runs"].items()}


CASES = {"steps": steps, "zero": zero, "loop": loop, "rn_tower": rn_tower, "mesh_steps": mesh_steps,
         "tp_blocks": tp_blocks, "ring_ops": ring_ops, "seq_trunk": seq_trunk, "mp_engine": mp_engine,
         "multi": multi}


def main(case: str, rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vipant_tpu_torch.parallel import distributed_init

    distributed_init("gloo", device="cpu", init_method=f"file://{d}/store", world_size=world,
                     rank=rank, timeout_s=120)
    spec = torch.load(os.path.join(d, "spec.pt"), weights_only=False)
    out = CASES[case](spec, rank, world)
    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
