"""U-Net with a ResNet-50 encoder: parameters and inference fold.

Counterpart of robosat_tpu/models/unet.py. Channel math matches the
reference robosat U-Net: center DecoderBlock(2048->256) on a 2x2-pooled
enc4, dec0(2048+256->256), dec1(1024+256->256), dec2(512+256->64),
dec3(256+64->128), dec4(128->32), dec5 ConvRelu(32->32), final 1x1 conv.
The forward pass the port runs is the hybrid-int8 walk in
robosat_tpu_torch/models/int8.py.
"""

import torch

from robosat_tpu_torch.models import resnet

NUM_FILTERS = 32


def init(seed, num_classes=2, num_filters=NUM_FILTERS, in_channels=3):
    """U-Net (params, state) from an int seed, drawn with a torch.Generator
    on the host (the values differ from the JAX package's init)."""
    gen = torch.Generator().manual_seed(int(seed))
    enc_params, enc_state = resnet.init(gen, in_channels=in_channels)
    nf = num_filters

    def conv3(cin, cout):
        return {"w": resnet.he_normal(gen, (3, 3, cin, cout))}

    params = {
        "encoder": enc_params,
        "center": conv3(2048, nf * 8),
        "dec0": conv3(2048 + nf * 8, nf * 8),
        "dec1": conv3(1024 + nf * 8, nf * 8),
        "dec2": conv3(512 + nf * 8, nf * 2),
        "dec3": conv3(256 + nf * 2, nf * 2 * 2),
        "dec4": conv3(nf * 2 * 2, nf),
        "dec5": conv3(nf, nf),
        "final": {"w": resnet.he_normal(gen, (1, 1, nf, num_classes)), "b": torch.zeros(num_classes)},
    }
    return params, {"encoder": enc_state}


def fold(params, state):
    """Inference-folded params: encoder BNs folded into their convs; the
    decoder has no BN, so its params pass through unchanged."""
    folded = dict(params)
    folded["encoder"] = resnet.fold(params["encoder"], state["encoder"])
    return folded
