"""Each cell cut to a size that a CPU test holds: two layers of width 64 (the
text tower 32), a 100-frame log-mel, 64-pixel frames, a batch of 8. The
cell's traffic, driver, checks and limits stay as they are."""

TINY_VIT = {"width": 64, "layers": 2, "heads": 4, "embed_dim": 32}
VIT_OVERRIDES = ["model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
                 "model.image.heads=4", "running.audio.max_len=100", "running.batch_size=8"]


def tiny(cell: dict, fp32: bool = False) -> dict:
    """``cell`` cut in place; with ``fp32`` the program computes in float32,
    as the reference does."""
    cfg, mix = cell["cfg"], cell["mix"]
    cfg["overrides"] = list(cfg["overrides"]) + VIT_OVERRIDES
    cfg["embed_dim"] = 32
    for name, t in cfg["towers"].items():
        if name == "image":
            t.update(TINY_VIT, input=[3, 64, 64])
            cfg["overrides"].append("model.image.resolution=64")
        elif name == "audio":
            t.update(TINY_VIT, input=[1, 100, 128])
        else:
            t.update(width=32, layers=2, heads=4, embed_dim=32)
            cfg["overrides"] += ["model.text.width=32", "model.text.heads=4", "model.text.encoder.layers=2"]
    mix.update(batch=8, reference_chunk=3)
    if "check_requests" in mix:
        mix.update(check_requests=4, trace_requests=2)
    else:
        mix.update(trace_steps=2)
    if fp32:
        cfg["overrides"].append("compute_dtype=float32")
        cfg["compute_dtype"] = "float32"
    return cell


def patch(fp32: bool = False):
    return lambda cell: tiny(cell, fp32)
