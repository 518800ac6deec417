"""Neural models of the port.

Counterpart of ``avd_tpu/models/__init__.py``.  The per-frame ViT
(``detector``) is ported; the ConvNeXt-style CNN and the temporal
transformer are queued in ``ROADMAP.md`` and raise until they land, so a
deployment that asks for them never gets another family in their place.
``scoring`` adapts the detector to the analyzer's timeline contract.
"""

FAMILIES = ("vit", "cnn", "temporal")


def family(name: str):
    """Return the model-family module for ``name``."""
    if name == "vit":
        from avd_tpu_torch.models import detector
        return detector
    if name in FAMILIES:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet (see ROADMAP.md); "
            "the port serves 'vit'")
    raise ValueError(f"unknown model family {name!r}; "
                     f"choose from {list(FAMILIES)}")
