"""3 × the ViT's forward FLOPs × the frames trained in the slice ÷ (slice
× the bf16 dense peak), %."""
from benchmark.readers import model_mfu
from benchmark.roofline import vit_forward


def read(run, trace):
    if trace is None or not trace.work.get("frames"):
        return None
    m = trace.work["model"]
    return model_mfu(trace, vit_forward.train_step_flops(
        trace.work["frames"], image_size=m["image_size"], patch=m["patch"],
        width=m["width"], heads=m["heads"], mlp=m["mlp"], depth=m["depth"]))
