"""The ResNet's 1x1 GEMM (``ops/bottleneck_gemm.py``) on the CPU: its plain
version against the frontend's former convolution, bias, residual add and
ReLU, bit for bit; the wrapper's checks; the frontend's choice of route, on tensors that say they lie on the card (CPU tensors of a subclass
whose ``device`` is ``cuda:0``, with factory calls on the card made on the
CPU) with the launch stubbed; the launch counts through a graph's capture
and its replays; and the kernel's arguments as the C function takes them."""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.overrides import TorchFunctionMode

from mocov2_whisper_flamingo_torch.decode import programs as P
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models.visual_frontend import FoldedConv2d, MoCoVisualFrontend
from mocov2_whisper_flamingo_torch.ops import bottleneck_gemm as BG
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

CL = torch.channels_last
CARD = torch.device("cuda", 0)


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the ops run on the CPU,
    and what they return says so too."""

    @property
    def device(self):
        return CARD

    @property
    def is_cuda(self):
        return True


def _host(arg):
    if isinstance(arg, (torch.device, str)) and torch.device(arg).type == "cuda":
        return torch.device("cpu"), True
    return arg, False


class CardFactories(TorchFunctionMode):
    """Calls that name the card (``torch.arange(..., device=x.device)``,
    ``t.to(x.device)``) run on the CPU and return ``OnCard`` tensors."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        args = list(args)
        moved = False
        for i, a in enumerate(args):
            args[i], m = _host(a)
            moved |= m
        if "device" in kwargs:
            kwargs["device"], m = _host(kwargs["device"])
            moved |= m
        out = func(*args, **kwargs)
        if moved and isinstance(out, torch.Tensor) and not isinstance(out, OnCard):
            out = out.as_subclass(OnCard)
        return out


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return t.detach().as_subclass(OnCard)


@pytest.fixture
def stubbed_launch(monkeypatch):
    """The kernel's launch replaced by its plain version (the weight comes
    as ``[C_out, C_in]``, the bias in fp32); the calls are recorded."""
    calls = []

    def launch(x, weight, bias, residual, stride, relu, tile):
        assert weight.dtype == x.dtype and weight.ndim == 2 and weight.is_contiguous()
        assert bias.dtype == torch.float32
        calls.append((tuple(x.shape), tuple(weight.shape), stride, relu, residual is not None,
                      tile))
        return BG.plain_bottleneck_gemm(x, weight[:, :, None, None], bias, stride, residual, relu)

    monkeypatch.setattr(BG, "_launch", launch)
    BG.reset_launches()
    yield calls
    BG.reset_launches()


def _conv(rng, c_in, c_out, stride, precision):
    conv = FoldedConv2d(c_in, c_out, 1, stride, 0, precision)
    conv.weight.data = torch.from_numpy(
        rng.standard_normal((c_out, c_in, 1, 1)).astype(np.float32) * 0.1)
    conv.bias.data = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32))
    return conv


def _act(rng, shape, dtype):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return x.contiguous(memory_format=CL)


# -- the plain version -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride, residual, relu", [
    (1, False, True),   # conv1
    (1, True, True),    # conv3 with the identity
    (1, False, False),  # a downsample at stride 1 (layer1)
    (2, False, False),  # a downsample at stride 2
    (2, True, True),
])
def test_plain_version_equals_the_former_conv_bias_add_relu_bit_for_bit(rng, dtype, stride,
                                                                         residual, relu):
    precision = L.Precision(compute_dtype=dtype)
    conv = _conv(rng, 64, 128, stride, precision)
    x = _act(rng, (3, 64, 9, 7), dtype)
    res = _act(rng, (3, 128, 5 if stride == 2 else 9, 4 if stride == 2 else 7), dtype)
    want = conv(x)  # FoldedConv2d's forward: the frontend's former 1x1 convolution
    if residual:
        want = want + res
    if relu:
        want = torch.relu(want)
    got = BG.plain_bottleneck_gemm(x, conv.weight, conv.bias, stride=stride,
                                   residual=res if residual else None, relu=relu)
    assert got.dtype == dtype and torch.equal(got, want)
    # The block's call of it, through the conv's precision.
    got = conv.gemm(x, residual=res if residual else None, relu=relu)
    assert got.dtype == dtype and torch.equal(got, want)


def test_bottleneck_routes_on_the_cpu_equal_the_former_block_bit_for_bit(rng):
    """A whole frontend on CPU tensors, BF16 and FP32: the blocks as they
    computed before the route (conv1 + ReLU, conv2 + ReLU, conv3, the
    downsample, the add and the ReLU, each through ``FoldedConv2d``)."""
    for precision in (L.BF16, L.FP32):
        torch.manual_seed(0)
        net = MoCoVisualFrontend(precision)
        for p in net.parameters():
            p.data.normal_(0.0, 0.05)
        video = torch.from_numpy(rng.standard_normal((1, 3, 3, 32, 32)).astype(np.float32))

        def former(block, x):
            h = torch.relu(block.conv1(x))
            h = torch.relu(block.conv2(h))
            h = block.conv3(h)
            identity = x if block.downsample is None else block.downsample(x)
            return torch.relu(h + identity)

        got = net(video, torch.tensor([2]))
        blocks = [b for i in range(1, 5) for b in getattr(net.body, f"layer{i}")]
        forwards = [b.forward for b in blocks]
        try:
            for b in blocks:
                b.forward = (lambda blk: lambda x: former(blk, x))(b)
            want = net(video, torch.tensor([2]))
        finally:
            for b, f in zip(blocks, forwards):
                b.forward = f
        assert torch.equal(got, want)


# -- the wrapper's checks -----------------------------------------------------------------


def _card_args(rng, **change):
    args = {"x": _on_card(_act(rng, (2, 64, 6, 6), torch.bfloat16)),
            "weight": _on_card(torch.zeros((256, 64, 1, 1))),
            "bias": _on_card(torch.zeros(256)), "stride": 1,
            "residual": _on_card(_act(rng, (2, 256, 6, 6), torch.bfloat16)), "relu": True}
    args.update(change)
    return args


@pytest.mark.parametrize("change, error, match", [
    ({"x": "fp32"}, TypeError, "bfloat16"),
    ({"x": "nchw"}, ValueError, "channels-last"),
    ({"x": "3d"}, ValueError, r"\[N, C_in, H, W\]"),
    ({"weight": torch.zeros((256, 64, 3, 3))}, ValueError, "1x1 weight"),
    ({"weight": torch.zeros((256, 32, 1, 1))}, ValueError, "1x1 weight"),
    ({"weight": torch.zeros((96, 64, 1, 1)), "bias": torch.zeros(96), "residual": None},
     ValueError, "multiples of 64"),
    ({"bias": torch.zeros(128)}, ValueError, "bias"),
    ({"stride": 3}, ValueError, "stride 1 or 2"),
    ({"residual": "shape"}, ValueError, "residual"),
    ({"residual": "fp32"}, TypeError, "residual"),
    ({"residual": "nchw"}, ValueError, "residual"),
    ({"weight": "cpu"}, ValueError, "lies on cpu"),
    ({"x": "wide"}, ValueError, "128 output columns"),
    ({"x": "offset"}, ValueError, "16-byte aligned"),
])
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take(rng, stubbed_launch, change,
                                                                error, match):
    args = _card_args(rng)
    x = args["x"]
    variants = {
        ("x", "fp32"): lambda: x.float(),
        ("x", "nchw"): lambda: x.contiguous(),
        ("x", "3d"): lambda: x[0],
        ("x", "wide"): lambda: _on_card(_act(rng, (1, 64, 2, 258), torch.bfloat16)),
        ("x", "offset"): lambda: _on_card(torch.zeros(2 * 6 * 6 * 64 + 4, dtype=torch.bfloat16)[4:]
                                          .view(2, 6, 6, 64).permute(0, 3, 1, 2)),
        ("residual", "shape"): lambda: args["residual"][:1],
        ("residual", "fp32"): lambda: args["residual"].float(),
        ("residual", "nchw"): lambda: args["residual"].contiguous(),
        ("weight", "cpu"): lambda: torch.zeros((256, 64, 1, 1)),
    }
    for key, value in change.items():
        if isinstance(value, str):
            args[key] = variants[(key, value)]()
        else:
            args[key] = _on_card(value) if isinstance(value, torch.Tensor) else value
    if change.get("x") == "wide":
        args.update(stride=2, residual=None)
    with pytest.raises(error, match=match):
        BG.bottleneck_gemm(**args)
    assert BG.launches == 0 and not stubbed_launch


def test_kernel_wrapper_takes_what_it_checks(rng, stubbed_launch):
    args = _card_args(rng)
    out = BG.bottleneck_gemm(**args)
    assert isinstance(out, OnCard) and out.is_contiguous(memory_format=CL)
    assert BG.launches == 1 and dict(BG.launches_by_kernel) == {"bottleneck_gemm<256>": 1}


@pytest.mark.parametrize("where", ["x", "weight", "bias", "residual"])
def test_wrapper_raises_on_an_input_that_requires_grad(rng, where):
    args = {"x": _act(rng, (2, 64, 4, 4), torch.float32), "weight": torch.zeros((64, 64, 1, 1)),
            "bias": torch.zeros(64), "residual": _act(rng, (2, 64, 4, 4), torch.float32)}
    args[where].requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        BG.bottleneck_gemm(**args)


def test_wrapper_refuses_a_device_other_than_cuda_or_cpu():
    x = torch.zeros((1, 64, 4, 4), device="meta").contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="runs on CUDA tensors, not meta"):
        BG.bottleneck_gemm(x, torch.zeros((64, 64, 1, 1), device="meta"),
                           torch.zeros(64, device="meta"))


def test_wrapper_refuses_cpu_tensors(rng, stubbed_launch):
    """The wrapper is the kernel alone: a CPU tensor raises (the block picks
    the plain version for it), and nothing is launched or counted."""
    x = _act(rng, (1, 64, 4, 4), torch.bfloat16)
    with pytest.raises(ValueError, match="runs on CUDA tensors, not cpu"):
        BG.bottleneck_gemm(x, torch.zeros((64, 64, 1, 1)), torch.zeros(64))
    assert BG.launches == 0 and not stubbed_launch


def test_tile_width_is_the_widest_that_divides_the_output():
    assert [BG.tile_n(c) for c in (64, 128, 192, 256, 512, 1024, 2048)] == [
        64, 128, 64, 256, 256, 256, 256]


# -- the route --------------------------------------------------------------------------------


def _frontend_on_card(net, video, lengths):
    params = {k: _on_card(v) for k, v in net.named_parameters()}
    with CardFactories():
        return functional_call(net, params, (_on_card(video), _on_card(lengths)))


@pytest.mark.parametrize("precision, launches", [(L.BF16, 36), (L.FP32, 0)])
def test_frontend_routes_its_1x1_convs_by_device_and_dtype(rng, stubbed_launch, precision,
                                                          launches):
    """A frontend forward on the card: in bf16, the 36 1x1 convs of the 16
    blocks through the kernel (3 conv1 of 64 wide, 4 conv1 of 128, the rest
    256 a tile), the same values as the CPU; in fp32 none. On the CPU none."""
    torch.manual_seed(0)
    net = MoCoVisualFrontend(precision)
    for p in net.parameters():
        p.data.normal_(0.0, 0.05)
    video = torch.from_numpy(rng.standard_normal((1, 3, 3, 32, 32)).astype(np.float32))
    lengths = torch.tensor([2])
    want = net(video, lengths)
    assert BG.launches == 0 and not stubbed_launch
    got = _frontend_on_card(net, video, lengths)
    assert isinstance(got, OnCard) and torch.equal(got.as_subclass(torch.Tensor), want)
    assert BG.launches == launches == len(stubbed_launch)
    if launches:
        assert dict(BG.launches_by_kernel) == {"bottleneck_gemm<64>": 3,
                                               "bottleneck_gemm<128>": 4,
                                               "bottleneck_gemm<256>": 29}
        kinds = collections.Counter((stride, relu, res) for *_, stride, relu, res, _ in
                                    stubbed_launch)
        assert kinds == {(1, True, False): 16, (1, True, True): 16, (1, False, False): 1,
                         (2, False, False): 3}


def test_frontend_under_export_takes_the_plain_version(rng, stubbed_launch, monkeypatch):
    net = MoCoVisualFrontend(L.BF16)
    x = _on_card(_act(rng, (1, 64, 4, 4), torch.bfloat16))
    assert BG.takes_kernel(x) and not BG.takes_kernel(x.float())
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert not BG.takes_kernel(x)
    video = torch.zeros((1, 2, 3, 32, 32))
    _frontend_on_card(net, video, torch.tensor([2]))
    assert BG.launches == 0 and not stubbed_launch


@pytest.mark.parametrize("where", ["plain_gemm", "as_traced"])
def test_frontend_inside_the_export_reference_takes_the_plain_version(rng, stubbed_launch,
                                                                      where):
    """A block's ``plain_gemm`` (set on every block by
    ``tools/export_model.py::as_traced``, which also puts the attention on
    its plain backend) makes the live frontend compute its 1x1 convolutions
    as an export traces them, and only while it is set: the reference an
    artifact is held against."""
    from mocov2_whisper_flamingo_torch.tools import export_model

    torch.manual_seed(0)
    net = MoCoVisualFrontend(L.BF16)
    for p in net.parameters():
        p.data.normal_(0.0, 0.05)
    video = torch.from_numpy(rng.standard_normal((1, 2, 3, 32, 32)).astype(np.float32))
    want = net(video, torch.tensor([2]))
    owner = _Owner(net)
    blocks = _blocks(net)
    if where == "as_traced":
        with export_model.as_traced(owner):
            assert owner.backend == "plain" and all(b.plain_gemm for b in blocks)
            got = _frontend_on_card(net, video, torch.tensor([2]))
    else:
        for b in blocks:
            b.plain_gemm = True
        got = _frontend_on_card(net, video, torch.tensor([2]))
        for b in blocks:
            b.plain_gemm = False
    assert BG.launches == 0 and not stubbed_launch and owner.backend == "flash"
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    _frontend_on_card(net, video, torch.tensor([2]))
    assert BG.launches == 36


class _Owner(torch.nn.Module):
    """A net with an attention backend, as ``AVNet`` has."""

    def __init__(self, frontend):
        super().__init__()
        self.frontend, self.backend = frontend, "flash"

    def set_attention_backend(self, backend):
        self.backend = backend


def _blocks(net):
    return [b for i in range(1, 5) for b in getattr(net.body, f"layer{i}")]


def test_as_traced_restores_each_block_s_own_choice(rng, stubbed_launch):
    """``as_traced`` is per net: it leaves another net's blocks on the kernel
    while it is open, and puts back what each of its own blocks had."""
    from mocov2_whisper_flamingo_torch.tools import export_model

    torch.manual_seed(0)
    net, other = MoCoVisualFrontend(L.BF16), MoCoVisualFrontend(L.BF16)
    blocks = _blocks(net)
    blocks[0].plain_gemm = True
    with export_model.as_traced(_Owner(net)):
        assert all(b.plain_gemm for b in blocks)
        _frontend_on_card(other, torch.zeros((1, 2, 3, 32, 32)), torch.tensor([2]))
        assert BG.launches == 36
    assert [b.plain_gemm for b in blocks] == [True] + [False] * 15
    assert not any(b.plain_gemm for b in _blocks(other))
    BG.reset_launches()
    _frontend_on_card(net, torch.zeros((1, 2, 3, 32, 32)), torch.tensor([2]))
    assert BG.launches == 33  # the first block's three 1x1 convs stay plain


# -- the counts through a graph ------------------------------------------------------------


def test_launch_counts_leave_out_uncounted_work_and_take_credit(rng, stubbed_launch):
    args = _card_args(rng)
    BG.bottleneck_gemm(**args)
    out, n, by = BG.uncounted(lambda: [BG.bottleneck_gemm(**args) for _ in range(2)])
    assert len(out) == 2 and (n, dict(by)) == (2, {"bottleneck_gemm<256>": 2})
    assert BG.launches == 1
    BG.credit(n, by)
    assert BG.launches == 3 and BG.launches_by_kernel["bottleneck_gemm<256>"] == 3


def test_graph_pool_credits_a_capture_s_gemm_launches_once_per_replay(rng, stubbed_launch):
    """``decode/programs.py``: what a capture launches is left out of the
    counts and kept with the graph; each replay adds it once."""
    args = _card_args(rng)
    out, launched = P._uncounted(lambda: [BG.bottleneck_gemm(**args) for _ in range(36)])
    assert BG.launches == 0 and launched[2][0] == 36

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    graph, pool = Graph(), P.GraphPool()
    graph.launched = launched
    for i in range(1, 4):
        pool.replay(graph)
        assert BG.launches == 36 * i and graph.replays == pool.replays == i
    assert dict(BG.launches_by_kernel) == {"bottleneck_gemm<256>": 108}


@pytest.mark.parametrize("which", ["k1", "ctc", "bottleneck_gemm"])
def test_graph_pool_keeps_and_credits_each_counted_kernel_apart(which):
    """Every kernel of ``decode/programs.py::COUNTED`` is left out of its own
    count by a capture, kept in its own slot, and credited to its own count
    alone at each replay."""
    for kernel in P.COUNTED.values():
        kernel.reset_launches()
    counter = P.COUNTED[which]
    out, launched = P._uncounted(lambda: counter.credit(5, collections.Counter({which: 5})) or 7)
    assert out == 7 and len(launched) == len(P.COUNTED)
    assert [n for n, _ in launched] == [5 if name == which else 0 for name in P.COUNTED]
    assert all(kernel.launches == 0 for kernel in P.COUNTED.values())

    class Graph:
        def replay(self):
            pass

    graph, pool = Graph(), P.GraphPool()
    graph.launched = launched
    pool.replay(graph)
    pool.replay(graph)
    assert {name: kernel.launches for name, kernel in P.COUNTED.items()} == {
        name: 10 if name == which else 0 for name in P.COUNTED}
    assert dict(counter.launches_by_kernel) == {which: 10}
    for kernel in P.COUNTED.values():
        kernel.reset_launches()


# -- the launch -------------------------------------------------------------------------------


def test_launch_passes_the_c_function_its_arguments_and_raises_when_refused(rng, monkeypatch):
    """``_launch`` hands ``csrc/bottleneck_gemm.cu::bottleneck_gemm`` the
    pointers, the sizes in its order, the tile width, one block per SM and
    the stream; a status other than 0 raises."""
    got = []

    class Fn:
        rc = 0

        def __call__(self, *a):
            got.append(a)
            return self.rc

    fn = Fn()
    monkeypatch.setattr(BG, "_kernel_fn", lambda: fn)
    monkeypatch.setattr(BG, "_sm_count", lambda index: 132)

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    x = _on_card(_act(rng, (3, 64, 9, 7), torch.bfloat16))
    w = _on_card(torch.zeros((512, 64), dtype=torch.bfloat16))
    b = _on_card(torch.zeros(512))
    with CardFactories():
        out = BG._launch(x, w, b, None, 2, False, 256)
    assert tuple(out.shape) == (3, 512, 5, 4) and out.is_contiguous(memory_format=CL)
    (args,) = got
    assert args[:5] == (x.data_ptr(), w.data_ptr(), b.data_ptr(), None, out.data_ptr())
    assert args[5:] == (3, 9, 7, 64, 512, 2, 0, 256, 132, 7)
    fn.rc = -1
    with CardFactories(), pytest.raises(RuntimeError, match="does not take"):
        BG._launch(x, w, b, None, 2, False, 256)


def test_c_function_signature_matches_the_wrapper():
    """The ctypes argument list against the C declaration: a pointer for
    each pointer (a ctypes int would cut it to 32 bits), an int for each int."""
    src = open(BG.__file__.rsplit("/ops/", 1)[0] + "/csrc/bottleneck_gemm.cu").read()
    decl = src[src.index('extern "C" int bottleneck_gemm('):]
    params = decl[decl.index("(") + 1:decl.index(")")].split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert BG.ARGTYPES == want and len(want) == 15
