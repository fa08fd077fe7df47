"""Analytic floating-point operation counts, written from the published
layer lists (Pix2Pose ``ae_model.py``: the paper generator at lines
70-150, the BOP'20 ResNet-50 generator at 175-240, the DCGAN discriminator
at 153-172; ResNet-50 stages 1-3 as Keras builds them), not from the
program's modules.

A multiply-add is 2 operations. Convolutions, transposed convolutions and
dense layers are counted; BatchNorm, activations, pooling, concatenation
and the losses are not (under 1% of each total). A transposed convolution
is counted on its input positions: every input pixel meets every kernel
tap once. Backward passes: the weight gradient costs one forward of the
layer, the input gradient another, except at a network's first layer
when its input needs no gradient.

Every count returns a list of layer operation counts, so that the
backward passes can drop the first layer's input gradient.
"""

from __future__ import annotations

PEAK_FP32 = 67e12  # NVIDIA H100 SXM, float32 outside the tensor cores


def conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> int:
    return 2 * cin * cout * k * k * h_out * w_out


def deconv(cin: int, cout: int, k: int, h_in: int, w_in: int) -> int:
    return 2 * cin * cout * k * k * h_in * w_in


def dense(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def _decoder(skip1: int) -> list[int]:
    """Bottleneck dense pair and the shared decoder (``ae_model.py:
    110-150``): 8x8x512 -> 256 -> 8x8x256, three (5x5/2 transposed conv,
    skip concat, 5x5 conv) stages, two 5x5/2 transposed-conv heads."""
    return [dense(8 * 8 * 512, 256), dense(256, 8 * 8 * 256),
            deconv(256, 256, 5, 8, 8), conv(256 + 128, 256, 5, 16, 16),
            deconv(256, 128, 5, 16, 16), conv(128 + 128, 256, 5, 32, 32),
            deconv(256, 64, 5, 32, 32), conv(64 + skip1, 128, 5, 64, 64),
            deconv(128, 3, 5, 64, 64), deconv(128, 1, 5, 64, 64)]


def paper_generator() -> list[int]:
    """One 128x128 crop through the ICCV'19 generator: four stages of two
    parallel 5x5/2 convs (64, 128, 128, 256 filters each) on the previous
    stage's concat, then the decoder."""
    layers, cin, size = [], 3, 128
    for ch in (64, 128, 128, 256):
        size //= 2
        layers += [conv(cin, ch, 5, size, size)] * 2
        cin = 2 * ch
    return layers + _decoder(64)


def resnet50_generator() -> list[int]:
    """One 128x128 crop through the BOP'20 generator: ResNet-50 stem
    (7x7/2, 64), stage 2 (3 bottlenecks, 64-64-256, at 32x32), stage 3
    (4 bottlenecks, 128-128-512, stride 2 on the first 1x1, at 16x16),
    one paired 5x5/2 stage to 8x8x512, then the decoder."""
    layers = [conv(3, 64, 7, 64, 64)]

    def block(cin, f, size, project):
        out = [conv(cin, f, 1, size, size), conv(f, f, 3, size, size),
               conv(f, 4 * f, 1, size, size)]
        return out + ([conv(cin, 4 * f, 1, size, size)] if project else [])

    layers += block(64, 64, 32, True) + block(256, 64, 32, False) * 2
    layers += block(256, 128, 16, True) + block(512, 128, 16, False) * 3
    layers += [conv(512, 256, 5, 8, 8)] * 2
    return layers + _decoder(32)


def discriminator(im_size: int = 128) -> list[int]:
    """Seven 3x3/2 conv blocks (64, 128, 256, then 512) and one logit."""
    layers, cin, size = [], 3, im_size
    for i in range(7):
        feats = 64 * min(8, 2 ** i)
        size = -(-size // 2)
        layers.append(conv(cin, feats, 3, size, size))
        cin = feats
    return layers + [dense(cin * size * size, 1)]


GENERATORS = {"paper": paper_generator, "resnet50": resnet50_generator}


def forward(layers: list[int]) -> int:
    return sum(layers)


def backward(layers: list[int], input_grad_first: bool,
             weight_grads: bool = True) -> int:
    """Weight gradients (one forward each, when ``weight_grads``) and input
    gradients (one forward each, the first layer's only when
    ``input_grad_first``)."""
    dx = sum(layers) - (0 if input_grad_first else layers[0])
    return dx + (sum(layers) if weight_grads else 0)


def gan_step(backbone: str, batch: int) -> int:
    """One GAN iteration (``3_train_pix2pose.py:209-222``): the fakes'
    generator pass; the discriminator's update on the fakes and on the
    reals (forward, weight and input gradients; no input gradient at its
    first layer); the generator update (generator forward, discriminator
    forward, the discriminator's input gradients only, the generator's
    weight and input gradients, none at its first layer's input)."""
    g = GENERATORS[backbone]()
    d = discriminator()
    per_sample = (forward(g)
                  + 2 * (forward(d) + backward(d, False))
                  + forward(g) + forward(d)
                  + backward(d, True, weight_grads=False)
                  + backward(g, False))
    return per_sample * batch
