"""Model registry of the port: the U-Net, the fast family and DeepLabv3+.

Counterpart of robosat_tpu/models/registry.py; SegFormer is not ported yet
(ROADMAP Queue 1, item 8).
"""

from robosat_tpu_torch.models import deeplab, fastnet, unet

_REGISTRY = {"unet": unet, "fast": fastnet, "deeplabv3plus": deeplab}


def get_model(name="unet"):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            "model '{}' is not ported to robosat_tpu_torch yet (SegFormer: ROADMAP Queue 1, item 8); "
            "available: {}".format(name, ", ".join(sorted(_REGISTRY)))
        ) from None
