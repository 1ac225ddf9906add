"""Model registry of the port: the U-Net, the fast family, DeepLabv3+ and SegFormer.

Counterpart of robosat_tpu/models/registry.py, with its four families and
its error for a name it does not hold.
"""

from robosat_tpu_torch.models import deeplab, fastnet, segformer, unet

_REGISTRY = {"unet": unet, "fast": fastnet, "deeplabv3plus": deeplab, "segformer": segformer}


def get_model(name="unet"):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError("unknown model '{}'; available: {}".format(name, ", ".join(sorted(_REGISTRY)))) from None
