"""ViT forward FLOPs of the frames scored in the slice (not the bucket's
padding) ÷ (slice × the bf16 dense peak), %."""
from benchmark.readers import model_mfu
from benchmark.roofline import vit_forward


def read(run, trace):
    if trace is None or not trace.work.get("frames") \
            or not trace.work.get("model"):
        return None
    m = trace.work["model"]
    per_frame = vit_forward.flops(m["image_size"], m["patch"], m["width"],
                                  m["heads"], m["mlp"], m["depth"])
    return model_mfu(trace, trace.work["frames"] * per_frame)
