"""Network-topology IR + builders for the paper's 18 benchmark CNNs.

§II.B.1: the Tool accepts a network as a list of typed layers —
``input / convolution / subsampling (pooling) / depth-convolution /
point-wise convolution`` (+ fully-connected).  Each layer carries the shape
parameters the row-stationary mapper needs: channels, filters, kernel size,
stride, padding and the (propagated) input feature-map size.

The 18 networks named in Tables 1–8 are provided as builders.  Structures
follow the public definitions (Keras Applications); for the two NASNet
variants — whose cell DAGs are enormous — we use a faithful separable-conv
approximation at the published channel/cell counts, which preserves the
per-layer compute/footprint distribution the simulator consumes.  Branch DAGs
(Inception/ResNet/DenseNet) are flattened in topological order: energy is
cumulative (§II.A.1), and the pipeline partitioner (Alg. II) operates on the
flattened layer latency vector exactly as the paper's tables do.

The PyTorch port keeps this module as its own copy of ``repro.core.topology`` (it
imports nothing from the JAX package); ``tests/test_torch_engine.py`` holds
the two copies equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

KIND_INPUT = "input"
KIND_CONV = "conv"
KIND_DW = "depthwise"
KIND_PW = "pointwise"
KIND_POOL = "pool"
KIND_FC = "fc"


@dataclasses.dataclass(frozen=True)
class Layer:
    """One network layer, fully shape-resolved."""

    name: str
    kind: str
    c_in: int       # input channels (C)
    c_out: int      # filters (M); == c_in for pool/depthwise
    k: int          # square kernel size (Kx = Ky)
    stride: int
    pad: int
    h_in: int
    w_in: int

    @property
    def h_out(self) -> int:
        return (self.h_in - self.k + 2 * self.pad) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w_in - self.k + 2 * self.pad) // self.stride + 1

    @property
    def macs(self) -> int:
        """MAC count (Algorithm I loop product)."""
        if self.kind == KIND_POOL or self.kind == KIND_INPUT:
            return 0
        ho, wo = self.h_out, self.w_out
        if self.kind == KIND_DW:
            return self.c_in * ho * wo * self.k * self.k
        return self.c_out * self.c_in * ho * wo * self.k * self.k

    @property
    def ifmap_words(self) -> int:
        return self.c_in * self.h_in * self.w_in

    @property
    def ofmap_words(self) -> int:
        return self.c_out * self.h_out * self.w_out

    @property
    def weight_words(self) -> int:
        if self.kind in (KIND_POOL, KIND_INPUT):
            return 0
        if self.kind == KIND_DW:
            return self.c_in * self.k * self.k
        return self.c_out * self.c_in * self.k * self.k


class NetBuilder:
    """Shape-propagating builder producing a flat ``List[Layer]``."""

    def __init__(self, name: str, input_hw: int = 224, c: int = 3):
        self.name = name
        self.layers: List[Layer] = [
            Layer("input", KIND_INPUT, c, c, 1, 1, 0, input_hw, input_hw)]
        self.h = input_hw
        self.w = input_hw
        self.c = c
        self._n = 0

    # -- primitives ---------------------------------------------------------
    def _add(self, kind: str, m: int, k: int, s: int, p: int) -> None:
        self._n += 1
        lyr = Layer(f"{kind}{self._n}", kind, self.c, m, k, s, p, self.h, self.w)
        self.layers.append(lyr)
        self.h, self.w, self.c = lyr.h_out, lyr.w_out, m

    def conv(self, m: int, k: int = 3, s: int = 1, p: int | None = None):
        self._add(KIND_CONV, m, k, s, k // 2 if p is None else p)
        return self

    def dw(self, k: int = 3, s: int = 1, p: int | None = None):
        self._add(KIND_DW, self.c, k, s, k // 2 if p is None else p)
        return self

    def pw(self, m: int):
        self._add(KIND_PW, m, 1, 1, 0)
        return self

    def sep(self, m: int, k: int = 3, s: int = 1):
        """Depthwise-separable conv = depthwise k×k + pointwise 1×1."""
        return self.dw(k, s).pw(m)

    def pool(self, k: int = 2, s: int | None = None, p: int = 0):
        self._add(KIND_POOL, self.c, k, k if s is None else s, p)
        return self

    def gap(self):
        """Global average pool → 1×1 spatial."""
        self._add(KIND_POOL, self.c, self.h, self.h, 0)
        return self

    def fc(self, n: int):
        # FC == 1×1 conv over a 1×1 map with C=inputs, M=outputs.
        if self.h != 1 or self.w != 1:
            # implicit flatten: fold spatial extent into channels
            self.c, self.h, self.w = self.c * self.h * self.w, 1, 1
        self._add(KIND_FC, n, 1, 1, 0)
        return self

    def branches(self, *fns: Callable[["NetBuilder"], None]):
        """Parallel branches from the current tensor; channel-concat output.

        Layers are appended in branch order (topological flattening)."""
        h0, w0, c0 = self.h, self.w, self.c
        out_c, out_h, out_w = 0, None, None
        for fn in fns:
            self.h, self.w, self.c = h0, w0, c0
            fn(self)
            if out_h is None:
                out_h, out_w = self.h, self.w
            assert (self.h, self.w) == (out_h, out_w), \
                f"branch spatial mismatch in {self.name}"
            out_c += self.c
        self.h, self.w, self.c = out_h, out_w, out_c
        return self

    def set_channels(self, c: int):
        """Channel bookkeeping for residual-add merges (no compute)."""
        self.c = c
        return self

    def build(self) -> List[Layer]:
        return list(self.layers)


# ---------------------------------------------------------------------------
# The 18 benchmark networks (Tables 1–8).
# ---------------------------------------------------------------------------

def alexnet() -> List[Layer]:
    b = NetBuilder("AlexNet", 227)
    b.conv(96, 11, 4, 0).pool(3, 2)
    b.conv(256, 5, 1, 2).pool(3, 2)
    b.conv(384).conv(384).conv(256).pool(3, 2)
    b.fc(4096).fc(4096).fc(1000)
    return b.build()


def _vgg(cfg: Sequence[int | str], name: str) -> List[Layer]:
    b = NetBuilder(name, 224)
    for v in cfg:
        if v == "M":
            b.pool(2, 2)
        else:
            b.conv(int(v), 3)
    b.fc(4096).fc(4096).fc(1000)
    return b.build()


def vgg16() -> List[Layer]:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"], "VGG16")


def vgg19() -> List[Layer]:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"], "VGG19")


def _resnet(blocks: Sequence[int], name: str) -> List[Layer]:
    b = NetBuilder(name, 224)
    b.conv(64, 7, 2, 3).pool(3, 2, 1)
    width = 64
    for stage, n in enumerate(blocks):
        for i in range(n):
            s = 2 if (stage > 0 and i == 0) else 1
            b.conv(width, 1, s, 0).conv(width, 3).pw(width * 4)
            b.set_channels(width * 4)   # residual add merge
        width *= 2
    b.gap().fc(1000)
    return b.build()


def resnet50() -> List[Layer]:
    return _resnet([3, 4, 6, 3], "ResNet50")


def resnet50v2() -> List[Layer]:
    return _resnet([3, 4, 6, 3], "ResNet50V2")   # pre-act: same cost shape


def resnet101() -> List[Layer]:
    return _resnet([3, 4, 23, 3], "ResNet101")


def resnet152() -> List[Layer]:
    return _resnet([3, 8, 36, 3], "ResNet152")


def _densenet(blocks: Sequence[int], name: str, growth: int = 32) -> List[Layer]:
    b = NetBuilder(name, 224)
    b.conv(64, 7, 2, 3).pool(3, 2, 1)
    c = 64
    for bi, n in enumerate(blocks):
        for _ in range(n):
            b.set_channels(c)
            b.pw(4 * growth).conv(growth, 3)
            c += growth
        b.set_channels(c)
        if bi != len(blocks) - 1:
            c = c // 2
            b.pw(c).pool(2, 2)          # transition
    b.gap().fc(1000)
    return b.build()


def densenet121() -> List[Layer]:
    return _densenet([6, 12, 24, 16], "DenseNet121")


def densenet169() -> List[Layer]:
    return _densenet([6, 12, 32, 32], "DenseNet169")


def densenet201() -> List[Layer]:
    return _densenet([6, 12, 48, 32], "DenseNet201")


def googlenet() -> List[Layer]:
    b = NetBuilder("GoogleNet", 224)
    b.conv(64, 7, 2, 3).pool(3, 2, 1).pw(64).conv(192, 3).pool(3, 2, 1)

    def inception(bld, c1, c3r, c3, c5r, c5, cp):
        bld.branches(
            lambda x: x.pw(c1),
            lambda x: x.pw(c3r).conv(c3, 3),
            lambda x: x.pw(c5r).conv(c5, 5),
            lambda x: x.pool(3, 1, 1).pw(cp),
        )

    inception(b, 64, 96, 128, 16, 32, 32)
    inception(b, 128, 128, 192, 32, 96, 64)
    b.pool(3, 2, 1)
    inception(b, 192, 96, 208, 16, 48, 64)
    inception(b, 160, 112, 224, 24, 64, 64)
    inception(b, 128, 128, 256, 24, 64, 64)
    inception(b, 112, 144, 288, 32, 64, 64)
    inception(b, 256, 160, 320, 32, 128, 128)
    b.pool(3, 2, 1)
    inception(b, 256, 160, 320, 32, 128, 128)
    inception(b, 384, 192, 384, 48, 128, 128)
    b.gap().fc(1000)
    return b.build()


def inception_v3() -> List[Layer]:
    b = NetBuilder("InceptionV3", 299)
    b.conv(32, 3, 2, 0).conv(32, 3, 1, 0).conv(64, 3, 1, 1).pool(3, 2)
    b.conv(80, 1, 1, 0).conv(192, 3, 1, 0).pool(3, 2)

    def mixed5(bld, cp):   # 35×35 modules
        bld.branches(
            lambda x: x.pw(64),
            lambda x: x.pw(48).conv(64, 5),
            lambda x: x.pw(64).conv(96, 3).conv(96, 3),
            lambda x: x.pool(3, 1, 1).pw(cp))

    for cp in (32, 64, 64):
        mixed5(b, cp)
    # reduction A
    b.branches(
        lambda x: x.conv(384, 3, 2, 0),
        lambda x: x.pw(64).conv(96, 3).conv(96, 3, 2, 0),
        lambda x: x.pool(3, 2))

    def mixed6(bld, c7):   # 17×17 factorized-7 modules
        bld.branches(
            lambda x: x.pw(192),
            lambda x: x.pw(c7).conv(c7, 7, p=3).conv(192, 7, p=3),
            lambda x: (x.pw(c7).conv(c7, 7, p=3).conv(c7, 7, p=3)
                       .conv(c7, 7, p=3).conv(192, 7, p=3)),
            lambda x: x.pool(3, 1, 1).pw(192))

    for c7 in (128, 160, 160, 192):
        mixed6(b, c7)
    # reduction B
    b.branches(
        lambda x: x.pw(192).conv(320, 3, 2, 0),
        lambda x: x.pw(192).conv(192, 7, p=3).conv(192, 3, 2, 0),
        lambda x: x.pool(3, 2))

    def mixed7(bld):       # 8×8 modules
        bld.branches(
            lambda x: x.pw(320),
            lambda x: x.pw(384).conv(384, 3),
            lambda x: x.pw(448).conv(384, 3).conv(384, 3),
            lambda x: x.pool(3, 1, 1).pw(192))

    mixed7(b)
    mixed7(b)
    b.gap().fc(1000)
    return b.build()


def inception_resnet_v2() -> List[Layer]:
    b = NetBuilder("InceptionResNetV2", 299)
    b.conv(32, 3, 2, 0).conv(32, 3, 1, 0).conv(64, 3).pool(3, 2)
    b.conv(80, 1, 1, 0).conv(192, 3, 1, 0).pool(3, 2)
    # stem mixed
    b.branches(
        lambda x: x.pw(96),
        lambda x: x.pw(48).conv(64, 5),
        lambda x: x.pw(64).conv(96, 3).conv(96, 3),
        lambda x: x.pool(3, 1, 1).pw(64))
    c_a = b.c  # 320
    for _ in range(10):                       # block35 ×10 (residual)
        b.branches(
            lambda x: x.pw(32),
            lambda x: x.pw(32).conv(32, 3),
            lambda x: x.pw(32).conv(48, 3).conv(64, 3))
        b.pw(c_a).set_channels(c_a)
    # reduction A
    b.branches(
        lambda x: x.conv(384, 3, 2, 0),
        lambda x: x.pw(256).conv(256, 3).conv(384, 3, 2, 0),
        lambda x: x.pool(3, 2))
    c_b = b.c  # 1088
    for _ in range(20):                       # block17 ×20
        b.branches(
            lambda x: x.pw(192),
            lambda x: x.pw(128).conv(160, 7, p=3).conv(192, 7, p=3))
        b.pw(c_b).set_channels(c_b)
    # reduction B
    b.branches(
        lambda x: x.pw(256).conv(384, 3, 2, 0),
        lambda x: x.pw(256).conv(288, 3, 2, 0),
        lambda x: x.pw(256).conv(288, 3).conv(320, 3, 2, 0),
        lambda x: x.pool(3, 2))
    c_c = b.c  # 2080
    for _ in range(10):                       # block8 ×10
        b.branches(
            lambda x: x.pw(192),
            lambda x: x.pw(192).conv(224, 3).conv(256, 3))
        b.pw(c_c).set_channels(c_c)
    b.pw(1536).gap().fc(1000)
    return b.build()


def mobilenet() -> List[Layer]:
    b = NetBuilder("MobileNet", 224)
    b.conv(32, 3, 2)
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
            (1024, 2), (1024, 1)]
    for m, s in plan:
        b.sep(m, 3, s)
    b.gap().fc(1000)
    return b.build()


def mobilenet_v2() -> List[Layer]:
    b = NetBuilder("MobileNetV2", 224)
    b.conv(32, 3, 2)
    # (expansion t, out c, repeats n, stride s)
    plan = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for t, c, n, s in plan:
        for i in range(n):
            hidden = b.c * t
            if t != 1:
                b.pw(hidden)
            b.dw(3, s if i == 0 else 1).pw(c)
    b.pw(1280).gap().fc(1000)
    return b.build()


def xception() -> List[Layer]:
    b = NetBuilder("Xception", 299)
    b.conv(32, 3, 2, 0).conv(64, 3, 1, 0)
    for m in (128, 256, 728):                 # entry flow
        b.sep(m).sep(m).pool(3, 2, 1)
    for _ in range(8):                        # middle flow
        b.sep(728).sep(728).sep(728)
    b.sep(728).sep(1024).pool(3, 2, 1)        # exit flow
    b.sep(1536).sep(2048).gap().fc(1000)
    return b.build()


def _nasnet(name: str, stem: int, filters: int, cells_per_stage: int,
            penultimate: int) -> List[Layer]:
    """Separable-conv approximation of the NASNet-A cell stacks.

    Each normal cell ≈ 5 separable ops (3×3 / 5×5) at the stage filter count;
    reduction cells halve spatial dims and double filters — matching the
    published filter schedule (Mobile: 12 cells @ N=4, penultimate 1056;
    Large: 18 cells @ N=6, penultimate 4032).
    """
    b = NetBuilder(name, 331 if name.endswith("Large") else 224)
    b.conv(stem, 3, 2, 0)
    # two stem reduction cells (spatial /4) before the first stack
    b.sep(filters // 2, 5, 2).sep(filters // 2, 3, 1)
    b.sep(filters, 5, 2).sep(filters, 3, 1)
    f = filters
    for stage in range(3):
        if stage > 0:
            b.sep(f, 5, 2).sep(f, 3, 1)       # reduction cell
        for _ in range(cells_per_stage):      # normal cells
            b.sep(f, 5).sep(f, 3).sep(f, 3).sep(f, 5).sep(f, 3)
        f *= 2
    b.pw(penultimate).gap().fc(1000)
    return b.build()


def nasnet_mobile() -> List[Layer]:
    return _nasnet("NASNetMobile", 32, 44, 4, 1056)


def nasnet_large() -> List[Layer]:
    return _nasnet("NASNetLarge", 96, 168, 6, 4032)


NETWORKS: Dict[str, Callable[[], List[Layer]]] = {
    "AlexNet": alexnet,
    "VGG16": vgg16,
    "VGG19": vgg19,
    "GoogleNet": googlenet,
    "InceptionV3": inception_v3,
    "InceptionResNetV2": inception_resnet_v2,
    "ResNet50": resnet50,
    "ResNet50V2": resnet50v2,
    "ResNet101": resnet101,
    "ResNet152": resnet152,
    "DenseNet121": densenet121,
    "DenseNet169": densenet169,
    "DenseNet201": densenet201,
    "MobileNet": mobilenet,
    "MobileNetV2": mobilenet_v2,
    "NASNetMobile": nasnet_mobile,
    "NASNetLarge": nasnet_large,
    "Xception": xception,
}

# The two heterogeneous categories of §IV (Table 5/6 discussion).
CATEGORY_1 = ("AlexNet", "DenseNet121", "DenseNet169", "DenseNet201",
              "ResNet50", "ResNet50V2", "ResNet101", "ResNet152")
CATEGORY_2 = ("VGG16", "VGG19", "GoogleNet", "MobileNet", "MobileNetV2",
              "NASNetLarge", "NASNetMobile", "Xception")
CATEGORY_EITHER = ("InceptionResNetV2", "InceptionV3")


def get_network(name: str) -> List[Layer]:
    return NETWORKS[name]()


def compute_layers(layers: Sequence[Layer]) -> List[Layer]:
    """Layers that perform MACs (what Alg. II distributes)."""
    return [l for l in layers if l.macs > 0]
