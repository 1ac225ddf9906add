"""Model registry of the port: the U-Net and the fast family.

Counterpart of robosat_tpu/models/registry.py; DeepLab and SegFormer are
not ported yet (ROADMAP Queue 1, item 8).
"""

from robosat_tpu_torch.models import fastnet, unet

_REGISTRY = {"unet": unet, "fast": fastnet}


def get_model(name="unet"):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            "model '{}' is not ported to robosat_tpu_torch yet (DeepLab and SegFormer: ROADMAP Queue 1, item 8); "
            "available: {}".format(name, ", ".join(sorted(_REGISTRY)))
        ) from None
