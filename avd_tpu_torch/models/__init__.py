"""Neural models of the port.

Counterpart of ``avd_tpu/models/__init__.py``: three detector families
with one functional API (``Config`` / ``PRESETS`` / ``make_config`` /
``param_shapes`` / ``init_params`` / ``cast_for_inference`` /
``forward``):

* ``detector`` — the per-frame ViT (default), dense or Switch-MoE;
* ``cnn``      — the ConvNeXt-style CNN;
* ``temporal`` — the transformer over the frame sequence
  (``forward_clip``).

``quant`` serves the ViT and the CNN in int8, ``convert`` carries
``avd_tpu``'s checkpoints across, and ``scoring`` adapts any family to the
analyzer's timeline contract (``AVD_DETECTOR_ARCH``).
"""

FAMILIES = ("vit", "cnn", "temporal")


def family(name: str):
    """Return the model-family module for ``name``."""
    if name == "cnn":
        from avd_tpu_torch.models import cnn
        return cnn
    if name == "vit":
        from avd_tpu_torch.models import detector
        return detector
    if name == "temporal":
        from avd_tpu_torch.models import temporal
        return temporal
    raise ValueError(f"unknown model family {name!r}; "
                     f"choose from {list(FAMILIES)}")
