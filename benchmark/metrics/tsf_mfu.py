"""TimeSformer forward FLOPs of the windows forwarded in the slice (the
``windows`` of the ``det.forward`` spans that ended in it) ÷ (slice × the
bf16 dense peak), %."""
from benchmark import spans
from benchmark.readers import model_mfu
from benchmark.roofline import timesformer_forward


def read(run, trace):
    m = run.data.get("timesformer")
    recs = spans.ended(trace, "det.forward")
    if not m or recs is None:
        return None
    windows = sum(r.attrs.get("windows", 0) for r in recs)
    per_window = timesformer_forward.flops(
        m["image_size"], m["patch"], m["frames"], m["width"], m["heads"],
        m["mlp"], m["depth"])
    return model_mfu(trace, windows * per_window)
