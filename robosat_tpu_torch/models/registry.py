"""Model registry of the port: the U-Net only.

Counterpart of robosat_tpu/models/registry.py; the other families
(DeepLab, SegFormer, FastNet) are not ported yet (ROADMAP Queue 1, item 8).
"""

from robosat_tpu_torch.models import unet

_REGISTRY = {"unet": unet}


def get_model(name="unet"):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            "model '{}' is not ported to robosat_tpu_torch yet (ROADMAP Queue 1, item 8); available: {}".format(
                name, ", ".join(sorted(_REGISTRY))
            )
        ) from None
