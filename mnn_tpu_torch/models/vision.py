"""Classic CNN architectures (MobileNetV2, SqueezeNet 1.0, ResNet-50).

Counterpart of the JAX package's `models/vision.py`, kept as its own copy:
the modules are plain torch at the published architectures (224 x 224
input, 1,000 classes by default), and `load_vision` lowers one through
`convert/torch_fx.py` onto `ops/nn_ops.py`, as the JAX package lowers them
onto `lax`.
"""

from __future__ import annotations


def _torch():
    import torch
    import torch.nn as nn

    return torch, nn


def mobilenet_v2(num_classes: int = 1000, width: float = 1.0):
    torch, nn = _torch()

    def c(ch):
        return max(8, int(ch * width + 4) // 8 * 8)

    def conv_bn(cin, cout, stride, k=3, groups=1):
        pad = (k - 1) // 2
        return nn.Sequential(
            nn.Conv2d(cin, cout, k, stride, pad, groups=groups, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU6(),
        )

    class InvRes(nn.Module):
        def __init__(self, cin, cout, stride, expand):
            super().__init__()
            h = cin * expand
            layers = []
            if expand != 1:
                layers.append(conv_bn(cin, h, 1, k=1))
            layers += [
                conv_bn(h, h, stride, k=3, groups=h),
                nn.Conv2d(h, cout, 1, bias=False),
                nn.BatchNorm2d(cout),
            ]
            self.conv = nn.Sequential(*layers)
            self.use_res = stride == 1 and cin == cout

        def forward(self, x):
            out = self.conv(x)
            return x + out if self.use_res else out

    cfg = [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    layers = [conv_bn(3, c(32), 2)]
    cin = c(32)
    for t, ch, n, s in cfg:
        for i in range(n):
            layers.append(InvRes(cin, c(ch), s if i == 0 else 1, t))
            cin = c(ch)
    layers.append(conv_bn(cin, c(1280), 1, k=1))

    class MobileNetV2(nn.Module):
        def __init__(self):
            super().__init__()
            self.features = nn.Sequential(*layers)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.classifier = nn.Linear(c(1280), num_classes)

        def forward(self, x):
            x = self.features(x)
            x = self.pool(x)
            x = torch.flatten(x, 1)
            return self.classifier(x)

    return MobileNetV2()


def squeezenet_v1_0(num_classes: int = 1000):
    torch, nn = _torch()

    class Fire(nn.Module):
        def __init__(self, cin, squeeze, e1, e3):
            super().__init__()
            self.squeeze = nn.Conv2d(cin, squeeze, 1)
            self.e1 = nn.Conv2d(squeeze, e1, 1)
            self.e3 = nn.Conv2d(squeeze, e3, 3, padding=1)
            self.act = nn.ReLU()

        def forward(self, x):
            x = self.act(self.squeeze(x))
            return torch.cat([self.act(self.e1(x)), self.act(self.e3(x))], 1)

    class SqueezeNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.features = nn.Sequential(
                nn.Conv2d(3, 96, 7, 2), nn.ReLU(),
                nn.MaxPool2d(3, 2, ceil_mode=True),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128),
                nn.MaxPool2d(3, 2, ceil_mode=True),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                nn.MaxPool2d(3, 2, ceil_mode=True),
                Fire(512, 64, 256, 256),
            )
            self.classifier = nn.Sequential(
                nn.Dropout(), nn.Conv2d(512, num_classes, 1), nn.ReLU(),
                nn.AdaptiveAvgPool2d(1),
            )

        def forward(self, x):
            x = self.features(x)
            x = self.classifier(x)
            return torch.flatten(x, 1)

    return SqueezeNet()


def resnet50(num_classes: int = 1000):
    torch, nn = _torch()

    class Bottleneck(nn.Module):
        def __init__(self, cin, width, stride=1, downsample=False):
            super().__init__()
            cout = width * 4
            self.c1 = nn.Conv2d(cin, width, 1, bias=False)
            self.b1 = nn.BatchNorm2d(width)
            self.c2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
            self.b2 = nn.BatchNorm2d(width)
            self.c3 = nn.Conv2d(width, cout, 1, bias=False)
            self.b3 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU()
            self.down = (
                nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                              nn.BatchNorm2d(cout))
                if downsample else None
            )

        def forward(self, x):
            idn = x if self.down is None else self.down(x)
            y = self.relu(self.b1(self.c1(x)))
            y = self.relu(self.b2(self.c2(y)))
            y = self.b3(self.c3(y))
            return self.relu(y + idn)

    def stage(cin, width, blocks, stride):
        layers = [Bottleneck(cin, width, stride, downsample=True)]
        for _ in range(blocks - 1):
            layers.append(Bottleneck(width * 4, width))
        return nn.Sequential(*layers)

    class ResNet50(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
                nn.ReLU(), nn.MaxPool2d(3, 2, 1),
            )
            self.layer1 = stage(64, 64, 3, 1)
            self.layer2 = stage(256, 128, 4, 2)
            self.layer3 = stage(512, 256, 6, 2)
            self.layer4 = stage(1024, 512, 3, 2)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(2048, num_classes)

        def forward(self, x):
            x = self.stem(x)
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            x = self.pool(x)
            x = torch.flatten(x, 1)
            return self.fc(x)

    return ResNet50()


VISION_MODELS = {
    "mobilenet_v2": mobilenet_v2,
    "squeezenet_v1.0": squeezenet_v1_0,
    "resnet50": resnet50,
}


def load_vision(name: str, num_classes: int = 1000, device=None):
    """-> (fn(params, x_nchw), params) via the torch.fx frontend, the
    module's weights (torch's default init under the caller's seed) on
    `device` (the card when None)."""
    from mnn_tpu_torch.convert.torch_fx import convert_torch_module

    mod = VISION_MODELS[name](num_classes)
    return convert_torch_module(mod, device=device)
