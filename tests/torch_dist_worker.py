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
        from_jax.load_params(tr.model, spec["params"])
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


CASES = {"steps": steps, "zero": zero, "loop": loop, "rn_tower": rn_tower}


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
