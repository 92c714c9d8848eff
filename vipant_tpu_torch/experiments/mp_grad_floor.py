"""How far the bf16 grads of the flagship VA step move when only the order
of their sums changes, and where the model, pipe and seq axes put them.

On one card, at B = 16 (``chip_smoke.py``'s ``mp_phase`` batch): the
one-rank step on the kernels (K), the same step on the batch in reversed
order (its loss and grads equal K's in exact arithmetic), the plain ops in
bf16 (P) and in fp32 (F); then 2 gloo ranks sharing ``cuda:0`` take the
step on ``mesh.model=2`` (kernels, and plain fp32), ``mesh.pipe=2`` with 4
microbatches and ``mesh.seq=2``. Each comparison prints the per-grad cosine
(its minimum, the count below 0.999, the lowest four) and the whole-grad
cosine; for an axis against F also the smallest cos(axis, F) - cos(K, F)::

    python vipant_tpu_torch/experiments/mp_grad_floor.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = 16
AXES = {"model": ["mesh.model=2"], "pipe": ["mesh.pipe=2", "mesh.microbatches=4"], "seq": ["mesh.seq=2"]}


def grads_of(torch, tr, batch):
    from vipant_tpu_torch.train import loss_and_grads, reduce_grads
    loss, g = loss_and_grads(tr.state, *batch)
    return float(loss), {k: v.float() for k, v in reduce_grads(tr.state, g).items()}


def stats(torch, cs, g, ref, name):
    cos = {k: cs._cos(torch, g[k], ref[k]) for k in ref}
    low = sorted(cos.items(), key=lambda kv: kv[1])[:4]
    flat = cs._cos(torch, torch.cat([g[k].flatten() for k in ref]), torch.cat([ref[k].flatten() for k in ref]))
    return {"vs": name, "min": low[0][1], "below_0.999": sum(c < 0.999 for c in cos.values()),
            "n": len(cos), "whole": flat, "lowest": [(k, round(c, 6)) for k, c in low]}, cos


def rank_main(rank, d):
    sys.path.insert(0, ROOT)
    import contextlib

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from vipant_tpu_torch.ops import _build
    from vipant_tpu_torch.parallel import distributed_init
    from vipant_tpu_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    torch.cuda.set_device(0)
    distributed_init("gloo", device="cuda:0", init_method=f"file://{d}/store", world_size=2, rank=rank, timeout_s=600)
    ref = torch.load(os.path.join(d, "ref.pt"), map_location="cuda:0")
    out = {}
    for axis, extra in AXES.items():
        for mode in ("bf16", "fp32"):
            if mode == "fp32" and axis != "model":
                continue
            torch.cuda.empty_cache()
            over = cs.FLAGSHIP + [f"running.batch_size={B}", "mesh.data=-1", *extra] + (["compute_dtype=float32"] if mode == "fp32" else [])
            ctx = cs.plain_ops() if mode == "fp32" else contextlib.nullcontext()
            with ctx:
                tr = Trainer(over, device="cuda:0", steps_per_epoch=cs.STEPS_PER_EPOCH)
                batch = tr.make_batch(*cs._dp_batch(B, seed=21))
                loss, g = grads_of(torch, tr, batch)
            full = {k: v.float() for k, v in tr.placement.full(g, tr.full_names[0]).items()}
            res = {"loss": loss}
            for name in (("K", "F") if mode == "bf16" else ("F",)):
                res[name], cos = stats(torch, cs, full, ref[name], name)
                if name == "F":
                    res["T_minus_K_vs_F_min"] = min(cos[k] - ref["cosKF"][k] for k in cos)
            out[f"{axis}_{mode}"] = res
            del tr, g, full
    print(json.dumps({"rank": rank, **out}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from vipant_tpu_torch.ops import _build
    from vipant_tpu_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    if not torch.cuda.is_available():
        raise SystemExit("mp_grad_floor: needs a CUDA device")
    print(cs._smi(), flush=True)
    d = tempfile.mkdtemp(prefix="mp_grad_floor_")
    tr = cs._trainer(torch, B)
    batch = tr.make_batch(*cs._dp_batch(B, seed=21))
    lk, gk = grads_of(torch, tr, batch)
    rev = tr.make_batch(*(a[::-1].copy() for a in cs._dp_batch(B, seed=21)))
    lr, gr = grads_of(torch, tr, rev)
    del tr
    with cs.plain_ops():
        f = cs._trainer(torch, B, "compute_dtype=float32")
        lf, gf = grads_of(torch, f, f.make_batch(*cs._dp_batch(B, seed=21)))
        p = cs._trainer(torch, B)
        lp, gp = grads_of(torch, p, p.make_batch(*cs._dp_batch(B, seed=21)))
    del f, p
    floor, _ = stats(torch, cs, gr, gk, "K")
    kf, cos_kf = stats(torch, cs, gk, gf, "F")
    pk, _ = stats(torch, cs, gp, gk, "K")
    pf, _ = stats(torch, cs, gp, gf, "F")
    print(json.dumps({"losses": {"K": lk, "K_reversed": lr, "F": lf, "P": lp},
                      "K_reversed_vs_K": floor, "K_vs_F": kf, "P_vs_K": pk, "P_vs_F": pf}), flush=True)
    torch.save({"K": {k: v.cpu() for k, v in gk.items()}, "F": {k: v.cpu() for k, v in gf.items()},
                "cosKF": cos_kf}, os.path.join(d, "ref.pt"))
    del gk, gf, gr, gp
    torch.cuda.empty_cache()
    t0 = time.time()
    logs = [open(os.path.join(d, f"r{r}.log"), "w") for r in range(2)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), d], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env) for r in range(2)]
    try:
        for p_ in procs:
            p_.wait(timeout=900)
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
        for f in logs:
            f.close()
    for r in range(2):
        with open(os.path.join(d, f"r{r}.log")) as f:
            txt = f.read()
        found = [line for line in txt.splitlines() if line.startswith('{"rank"')]
        print(found[-1] if found else txt[-3000:], flush=True)
    print(f"ranks {time.time() - t0:.1f} s")
    shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
