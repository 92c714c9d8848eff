"""Times ``gemm_wgrad`` over every row split S of the training steps' weight
grads, beside the split :func:`~vipant_tpu_torch.ops.kernels.wgrad_split`
plans and beside ``torch.matmul`` of the same product (timed here, used
nowhere in the port). ``WGRAD_CHUNK_COST`` in ``ops/kernels.py`` was fitted
on this table: the planned S should be at or near the fastest of its row.

    python -m vipant_tpu_torch.experiments.wgrad_split_sweep     # needs a GPU

Shapes: the audio tower's four products at batch 64 (M = 19,584) and batch 4
(M = 1,224), the caption decoder's at batch 64 (M = 4,928). CUDA-event means
over 30 launches after 5 warm-ups; a row of small products is launch-bound
and noisy.
"""

from __future__ import annotations

import subprocess

import torch

from ..ops import kernels

SHAPES = [(M, n1, n2) for M, pairs in (
    (19584, ((768, 768), (2304, 768), (768, 3072), (3072, 768))),
    (4928, ((512, 512), (1536, 512), (512, 2048), (2048, 512))),
    (1224, ((768, 768), (2304, 768), (768, 3072), (3072, 768))),
) for n1, n2 in pairs]
MAX_SPLIT = 24


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def splits(M: int):
    """Every (S, rows_per_chunk) the kernel takes for M rows, S <= MAX_SPLIT."""
    steps = -(-M // kernels.WGRAD_STEP)
    seen = {}
    for per_chunk in range(steps, 0, -1):
        S = -(-steps // per_chunk)
        if S <= MAX_SPLIT:
            seen.setdefault(S, per_chunk * kernels.WGRAD_STEP)
    return sorted(seen.items())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_split_sweep: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    plan = kernels.wgrad_split
    g = torch.Generator(device="cuda").manual_seed(0)
    for M, N1, N2 in SHAPES:
        a = torch.randn(M, N1, generator=g, device="cuda").bfloat16()
        b = torch.randn(M, N2, generator=g, device="cuda").bfloat16()
        library = cuda_ms(lambda: torch.matmul(a.t(), b))
        times = {}
        try:
            for S, rows in splits(M):
                kernels.wgrad_split = lambda *_, S=S, rows=rows: (S, rows)
                times[S] = cuda_ms(lambda: kernels.gemm_wgrad(a, b))
        finally:
            kernels.wgrad_split = plan
        S_plan = plan(M, N1, N2)[0]
        planned = cuda_ms(lambda: kernels.gemm_wgrad(a, b))
        best = min(times, key=times.get)
        print(f"M={M} {N1}x{N2}: planned S={S_plan} {planned:.4f} ms "
              f"({2 * M * N1 * N2 / planned / 1e9:.0f} TFLOP/s); fastest S={best} {times[best]:.4f}; "
              f"torch.matmul {library:.4f}; by S: "
              + " ".join(f"{S}:{t:.4f}" for S, t in times.items()))


if __name__ == "__main__":
    main()
