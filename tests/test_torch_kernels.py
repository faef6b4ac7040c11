"""The port's kernel wrappers and their build, without JAX.

On the CPU: the dispatch sends CPU tensors to the plain version and
launches nothing, the CUDA wrapper refuses CPU tensors, and the ``nvcc``
build is cached by a hash of the sources and raises with the compiler's
stderr (both driven through a stand-in compiler script).

On the card (``cuda`` marker; skips without one): each hand-written
kernel against its plain version at tinyllama's head layout (QH=32, KH=4,
D=64), in f32 and bf16 — the ragged paged-attention kernel on valid rows,
the paged decode kernel on every row, released rows included, and the
flash-prefill kernel on every row, padded query rows included; the
best-window similarity kernel at the semantic path's three geometries
and the CPU tests' shapes, exact indices where window rows are
duplicated; and an unknown decode-kernel selector refusing to build the
wave engine.  The bf16 tensor-core kernels also at D = 16, 32, 64 and
128; the ragged kernel on long rows (2,048 positions at page 16 and at
page 96, so its split-KV runs with split edges on and off page edges, a
window emptying whole splits); the prefill kernel at T = 24 and
T = 2,048 and on padded rows a window leaves with no key.  The decode
kernel also on long rows (2,048 positions at page 16 and 64: rows
crossing many split edges, a window starting inside a split, released
rows beside long ones) at D = 16, 64 and 128 and the groups G = 3, 4, 7
and 8, and its merge counters left at zero; the similarity kernel also
at P = 19 and 33 with W at a share edge, W = 8 and 9, and rows of 768,
and at any D (100 and 385, off 16-byte vectors; 1,536 f32 and 4,096 bf16,
rows wider than 4 KB) with W in {1, 4096} and P in {19, 1024}.  The
operator's ``run_demo`` with ``tpu-native`` runs on the card and
launches K1 once per layer per step and K5 once.
The ragged kernel also at the prefix cache's hit geometry (a first
prefill chunk of 18 queries at kv_len 786 over head pages that rows
share), and the host pool's page transfers (gather, side-stream fetch to
pinned memory, restore) against the CPU's bytes.  A checkpoint written by
the port's ``save_params`` loads onto the card byte for byte as onto the
CPU (bf16 and int8), and ``TPUNativeProvider.generate`` over it launches
the ragged kernel.
The ragged kernel also at llama-3-8b's head layout (QH=32, KH=8,
D=128: the group of 4 the deployed model serves with), on short and
long rows, at the other families' groups of 7, 3 and 6 (D = 128) on
64-query chunks whose tiles cut a token's heads and on the long rows,
and with the decode and prefill kernels under mistral-7b's 4,096-token
window over 8,192 positions, and a supervised restart of a continuous engine on the card
(a stalled step, the supervisor's reset) leaves its device memory where
it was.  The fleet KV fabric on the card: a page gathered by one engine,
sent through the PMKV1 wire and restored by a second is the first's
device page byte for byte (and the second's greedy tokens the first's),
and the ragged kernel at llama-3-8b's heads over a page restored from the
wire agrees with its plain version.
On the CPU, the ragged kernel's launch plan is a function of shapes
alone, and the ragged and decode wrappers' copies of their kernels'
split geometry and the similarity wrapper's layouts are the sources' and
the library's.  This file imports no JAX, so it runs on a machine that
has only PyTorch::

    python -m pytest tests/test_torch_kernels.py -q
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from operator_tpu_torch.ops import _build  # noqa: E402
from operator_tpu_torch.ops import flash_prefill  # noqa: E402
# the module: the package's ``paged_attention`` is the function, as in JAX
paged = importlib.import_module("operator_tpu_torch.ops.paged_attention")
from operator_tpu_torch.ops import ragged_attention as ragged  # noqa: E402
from operator_tpu_torch.ops import similarity  # noqa: E402

B, C, QH, KH, D, PAGE, PPS = 4, 8, 32, 4, 64, 16, 6

#: name -> (kv_len, q_count, sliding_window): prefill-only, decode-only,
#: mixed, window, spec-verify, idle rows and kv lengths off the page grid
GEOMETRIES = {
    "prefill_only": ([8, 5, 8, 3], [8, 5, 8, 3], None),
    "decode_only": ([17, 90, 9, 1], [1, 1, 1, 1], None),
    "mixed": ([17, 20, 8, 0], [1, 6, 8, 0], None),
    "window": ([73, 20, 8, 12], [1, 6, 8, 1], 7),
    "spec_verify": ([21, 14, 40, 6], [5, 3, 2, 5], None),
    "q_count_0": ([17, 30, 9, 25], [0, 1, 0, 4], None),
    "ragged_kv_len": ([13, 27, 46, 7], [3, 1, 8, 7], 11),
}

#: f32: the kernel and the plain version sum in different orders; bf16:
#: the plain version rounds the probabilities to bf16 before P.V, the
#: kernel keeps them in f32 and rounds once at the end
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
#: the decode and prefill kernels, for the same reasons: in bf16 about
#: twice the largest error measured on the card (0.0156, a bf16 ulp at
#: magnitude 2)
WAVE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(name, dtype=torch.float32, device="cpu", d=D):
    kv_len, q_count, window = GEOMETRIES[name]
    return _paged_inputs(kv_len, q_count, window, PAGE, PPS, sum(map(ord, name)), dtype,
                         device, d)


def _paged_inputs(kv_len, q_count, window, page, pps, seed, dtype, device, d=D, qh=QH, kh=KH,
                  c=C):
    rng = np.random.default_rng(seed)
    b = len(kv_len)
    num_pages = b * pps + 1
    arrays = [
        rng.normal(size=(b, c, qh, d)).astype(np.float32),
        rng.normal(size=(num_pages, page, kh, d)).astype(np.float32),
        rng.normal(size=(num_pages, page, kh, d)).astype(np.float32),
    ]
    table = (1 + rng.permutation(num_pages - 1)[: b * pps]).reshape(b, pps)
    args = [torch.from_numpy(a).to(device, dtype) for a in arrays] + [
        torch.as_tensor(table, dtype=torch.int32, device=device),
        torch.as_tensor(kv_len, dtype=torch.int32, device=device),
        torch.as_tensor(q_count, dtype=torch.int32, device=device),
    ]
    return args, window, q_count


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_cpu_dispatch_takes_the_plain_version_and_launches_nothing(name):
    args, window, _ = _inputs(name)
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    assert ragged.launches == before
    assert got.shape == (B, C, QH, D) and got.dtype == torch.float32
    assert torch.equal(got, want)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_ragged_launch_plan_is_a_function_of_shapes():
    """The split plan reads shapes and dtype only: meta tensors (no data,
    nothing to read) give it, and tinyllama's serve shapes (B=32, C=64,
    QH=32, KH=4, D=64, 32 pages of 64) give 8 splits of 256 positions and
    17.3 MB of scratch."""
    bf16, i32 = torch.bfloat16, torch.int32
    plan = ragged.launch_plan(
        _meta((32, 64, 32, 64), bf16), _meta((32 * 32 + 1, 64, 4, 64), bf16), _meta((32, 32), i32)
    )
    assert plan == ragged.LaunchPlan(8, 256, (32, 4, 8, 64, 64), (32, 4, 8, 64, 2))
    assert 4 * (np.prod(plan.acc_shape) + np.prod(plan.ml_shape)) == 17_301_504  # f32 scratch
    # the same shapes with data: the same plan, whatever kv_len holds
    args, _, _ = _inputs("mixed", torch.bfloat16)
    for table_len in (PPS, 128):
        table = torch.zeros((B, table_len), dtype=torch.int32)
        want = ragged.launch_plan(_meta(args[0].shape, bf16), _meta(args[1].shape, bf16),
                                  _meta(table.shape, i32))
        assert ragged.launch_plan(args[0], args[1], table) == want
    # page 16 x 128 pages and page 96 x 22 pages: 2,048 and 2,112 positions
    split = ragged.launch_plan(args[0], args[1], torch.zeros((B, 128), dtype=i32))
    assert (split.n_splits, split.split_keys) == (8, 256)
    split = ragged.launch_plan(args[0], _meta((9, 96, KH, D), bf16), _meta((B, 22), i32))
    assert (split.n_splits, split.split_keys) == (9, 256)
    # short caches and f32 are not cut; long ones keep at most 16 splits
    assert ragged.launch_plan(args[0], args[1], table[:, :16]) == ragged.LaunchPlan(1, 0)
    assert ragged.launch_plan(args[0].float(), args[1].float(), table) == ragged.LaunchPlan(1, 0)
    long = ragged.launch_plan(args[0], args[1], _meta((B, 4096), i32))
    assert (long.n_splits, long.split_keys) == (16, 4096)


class _GeometryLibrary:
    """Stands in for the built library: ``ragged_attention_tc_geometry``
    reports ``values`` (tile rows, stage keys, most splits)."""

    def __init__(self, values):
        self.values = values

    def ragged_attention_tc_geometry(self, *refs):
        for ref, value in zip(refs, self.values):
            ref._obj.value = value


@pytest.mark.parametrize("drift", [None, 0, 1, 2], ids=["same", "tile_rows", "stage_keys", "max_splits"])
def test_ragged_wrapper_refuses_a_library_of_other_geometry(drift):
    """The wrapper sizes the split scratch from its own copy of the bf16
    kernel's geometry, so binding a library that reports another one
    raises before any launch."""
    values = [ragged.TILE_ROWS, ragged.STAGE_KEYS, ragged.MAX_SPLITS]
    if drift is None:
        ragged._check_geometry(_GeometryLibrary(values))
        return
    values[drift] *= 2
    with pytest.raises(RuntimeError, match="geometry"):
        ragged._check_geometry(_GeometryLibrary(values))


def test_ragged_wrapper_geometry_matches_the_kernel_sources():
    """The same copy against the constants in the CUDA sources, read as
    text (nothing is built): 16 flash rows a warp."""
    csrc = Path(ragged.__file__).resolve().parent / "csrc"

    def constant(source, name):
        found = re.search(rf"constexpr int {name} = (\d+);", (csrc / source).read_text())
        return int(found.group(1))

    assert ragged.TILE_ROWS == 16 * constant("ragged_attention.cu", "kTcWarps")
    assert ragged.STAGE_KEYS == constant("flash_common.cuh", "kTcKeys")
    assert ragged.MAX_SPLITS == constant("ragged_attention.cu", "kMaxSplits")


class _DecodeGeometryLibrary:
    """Stands in for the built decode library: ``paged_attention_tc_geometry``
    reports ``values`` (split rows, stage keys, most splits)."""

    def __init__(self, values):
        self.values = values

    def paged_attention_tc_geometry(self, *refs):
        for ref, value in zip(refs, self.values):
            ref._obj.value = value


@pytest.mark.parametrize("drift", [None, 0, 1, 2], ids=["same", "split_rows", "stage_keys", "max_splits"])
def test_decode_wrapper_refuses_a_library_of_other_geometry(drift):
    """The decode wrapper sizes its split scratch from its own copy of the
    bf16 kernel's geometry, so binding a library that reports another one
    raises before any launch."""
    values = [paged._MAX_GROUP, ragged.STAGE_KEYS, ragged.MAX_SPLITS]
    if drift is None:
        paged._check_geometry(_DecodeGeometryLibrary(values))
        return
    values[drift] *= 2
    with pytest.raises(RuntimeError, match="geometry"):
        paged._check_geometry(_DecodeGeometryLibrary(values))


def test_decode_wrapper_geometry_matches_the_kernel_sources():
    """The decode wrapper's copy against the constants in the CUDA sources,
    read as text (nothing is built)."""
    csrc = Path(paged.__file__).resolve().parent / "csrc"

    def constant(source, name):
        found = re.search(rf"constexpr int {name} = (\d+);", (csrc / source).read_text())
        return int(found.group(1))

    assert paged._MAX_GROUP == constant("paged_attention.cu", "kSplitRows")
    assert ragged.STAGE_KEYS == constant("flash_common.cuh", "kTcKeys")
    assert ragged.MAX_SPLITS == constant("paged_attention.cu", "kMaxSplits")


class _SimilarityGeometryLibrary:
    """Stands in for the built similarity library: ``best_window_geometry``
    reports ``configs`` ((patterns per block, window rows per tile) each)."""

    def __init__(self, configs):
        self.configs = configs

    def best_window_geometry(self, tile_p, tile_w):
        for i, (p, w) in enumerate(self.configs[: len(tile_p)]):
            tile_p[i], tile_w[i] = p, w
        return len(self.configs)


@pytest.mark.parametrize("drift", [None, "tile_p", "tile_w", "count"])
def test_similarity_wrapper_refuses_a_library_of_other_geometry(drift):
    """The similarity plan's layouts (which size the grid, the shares and
    the scratch) must be the library's own."""
    configs = [list(c) for c in similarity.CONFIGS]
    if drift == "tile_p":
        configs[3][0] = 32
    elif drift == "tile_w":
        configs[5][1] = 64
    elif drift == "count":
        configs.append([128, 128])
    library = _SimilarityGeometryLibrary([tuple(c) for c in configs])
    if drift is None:
        similarity._check_geometry(library)
        return
    with pytest.raises(RuntimeError, match="layouts"):
        similarity._check_geometry(library)


def test_cuda_wrapper_refuses_cpu_tensors():
    args, window, _ = _inputs("mixed")
    before = ragged.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ragged.ragged_attention_cuda(*args, sliding_window=window)
    assert ragged.launches == before


#: decode: name -> (lengths, sliding_window, released rows, page,
#: pages_per_seq) at B=8.  Short tables (page 16 x 6, one split): lengths
#: of 1, full pages, off the page grid and past the window.  Long tables
#: (2,048 positions, the bf16 kernel's 8 splits of 256): rows crossing
#: many split edges, one past and at an edge, at page 16 and page 64; a
#: window starting inside split 6, 4 and 0; released rows beside long ones
DECODE_GEOMETRIES = {
    "mixed": ([1, 16, 32, 17, 90, 96, 5, 63], None, (), 16, 6),
    "window": ([1, 16, 32, 17, 90, 96, 5, 63], 20, (), 16, 6),
    "released": ([17, 1, 96, 1, 40, 1, 3, 64], None, (1, 3, 5), 16, 6),
    "split_edges_page16": ([2048, 1, 256, 257, 1000, 1537, 513, 64], None, (), 16, 128),
    "split_edges_page64": ([2048, 1, 256, 257, 1000, 1537, 513, 64], None, (), 64, 32),
    "window_mid_split": ([2048, 1300, 700, 1, 260, 1024, 2000, 90], 300, (), 16, 128),
    "released_long": ([1500, 1, 1, 700, 1, 2048, 1, 33], None, (1, 2, 4, 6), 64, 32),
}
DB = 8


def _decode_inputs(name, dtype=torch.float32, device="cpu", qh=QH, kh=KH, d=D):
    lengths, window, released, page, pps = DECODE_GEOMETRIES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    num_pages = DB * pps + 1
    arrays = [
        rng.normal(size=(DB, qh, d)).astype(np.float32),
        rng.normal(size=(num_pages, page, kh, d)).astype(np.float32),
        rng.normal(size=(num_pages, page, kh, d)).astype(np.float32),
    ]
    table = (1 + rng.permutation(num_pages - 1)[: DB * pps]).reshape(DB, pps)
    table[list(released)] = 0  # released slots point at trash page 0
    args = [torch.from_numpy(a).to(device, dtype) for a in arrays] + [
        torch.as_tensor(table, dtype=torch.int32, device=device),
        torch.as_tensor(lengths, dtype=torch.int32, device=device),
    ]
    return args, window


#: prefill: name -> (T, lengths, sliding_window); "window_no_key": padded
#: tokens from 55 (length 40) and every token (length 0) have no key under
#: the window, in tiles of their own and in a tile beside live rows
PREFILL_GEOMETRIES = {
    "full": (64, [64], None),
    "ragged": (128, [128, 37, 1], None),
    "window": (128, [128, 70, 9], 24),
    "short_bucket": (24, [24, 7], None),
    "window_no_key": (128, [128, 40, 0], 16),
}
#: on the card only (the plain version's [T, T] scores are large for the
#: CPU tests): one long row
CARD_PREFILL_GEOMETRIES = {
    **PREFILL_GEOMETRIES,
    "long_b1": (2048, [1501], None),
    "long_window": (2048, [2048, 700], 300),
}


def _prefill_inputs(name, dtype=torch.float32, device="cpu", d=D):
    t, lengths, window = CARD_PREFILL_GEOMETRIES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    b = len(lengths)
    arrays = [
        rng.normal(size=(b, t, QH, d)).astype(np.float32),
        rng.normal(size=(b, t, KH, d)).astype(np.float32),
        rng.normal(size=(b, t, KH, d)).astype(np.float32),
    ]
    args = [torch.from_numpy(a).to(device, dtype) for a in arrays] + [
        torch.as_tensor(lengths, dtype=torch.int32, device=device)
    ]
    return args, window


@pytest.mark.parametrize("name", list(DECODE_GEOMETRIES))
def test_decode_cpu_dispatch_takes_the_plain_version(name):
    args, window = _decode_inputs(name)
    before = paged.launches
    got = paged.paged_attention(*args, sliding_window=window)
    assert paged.launches == before
    assert got.shape == (DB, QH, D) and torch.isfinite(got).all()
    assert torch.equal(got, paged.paged_attention_reference(*args, sliding_window=window))


@pytest.mark.parametrize("name", list(PREFILL_GEOMETRIES))
def test_prefill_cpu_dispatch_takes_the_plain_version(name):
    args, window = _prefill_inputs(name)
    before = flash_prefill.launches
    got = flash_prefill.flash_prefill_attention(*args, sliding_window=window)
    assert flash_prefill.launches == before
    assert got.shape == (args[0].shape[0], args[0].shape[1], QH * D)
    assert torch.equal(
        got, flash_prefill.flash_prefill_reference(*args, sliding_window=window)
    )


def test_new_cuda_wrappers_refuse_cpu_tensors():
    args, window = _decode_inputs("mixed")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        paged.paged_attention_cuda(*args, sliding_window=window)
    args, window = _prefill_inputs("ragged")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_prefill.flash_prefill_cuda(*args, sliding_window=window)


def _fake_nvcc(tmp_path, body):
    """A stand-in compiler: records each call, then runs ``body``."""
    script = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{calls}"\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        + body
    )
    script.chmod(0o755)
    return str(script), calls


def test_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    nvcc, calls = _fake_nvcc(tmp_path, 'echo built > "$out"\n')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setenv("OPERATOR_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    names = ["flash_prefill", "paged_attention", "ragged_attention", "similarity"]
    assert _build.source_names() == names
    _build.build_all()
    targets = [_build.library_path(name) for name in names]
    for target in targets:
        assert target.parent == tmp_path / "build" and target.read_text() == "built\n"
    _build.build_all()  # unchanged sources: nothing to build
    lines = calls.read_text().splitlines()
    assert len(lines) == len(names)  # one nvcc per source
    assert all("arch=compute_90a,code=sm_90a" in line for line in lines)
    assert sorted(line.split()[-1].rsplit("/", 1)[-1] for line in lines) == [
        f"{name}.cu" for name in names
    ]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        t.name for t in targets
    )


def test_failed_build_raises_with_the_compiler_stderr(tmp_path, monkeypatch):
    nvcc, _ = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic" >&2\nexit 3\n')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setenv("OPERATOR_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no such intrinsic"):
        _build.build_all(["ragged_attention"])
    assert list((tmp_path / "build").iterdir()) == []  # no half-built library


def test_chip_smoke_profile_counts_each_kernel_once():
    """A host-side operator carries the device time of the kernels it
    launched; the busy share must count the kernel events only."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    events = [
        SimpleNamespace(key="aten::mm", count=4, device_type=DeviceType.CPU,
                        self_device_time_total=900.0),
        SimpleNamespace(key="sgemm_kernel", count=4, device_type=DeviceType.CUDA,
                        self_device_time_total=900.0),
        SimpleNamespace(key="best_window_pass1", count=2, device_type=DeviceType.CUDA,
                        self_device_time_total=50.0),
        SimpleNamespace(key="aten::empty", count=9, device_type=DeviceType.CPU,
                        self_device_time_total=0.0),
    ]
    assert chip_smoke.device_times(events) == [
        ("sgemm_kernel", 0.9, 4), ("best_window_pass1", 0.05, 2),
    ]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_cuda_kernel_matches_plain_version(cuda, name, dtype_name):
    args, window, q_count = _inputs(name, getattr(torch, dtype_name), "cuda")
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert ragged.launches == before + 1
    assert got.dtype == args[0].dtype
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    for row, n in enumerate(q_count):
        if n:
            diff = (got[row, :n].float() - want[row, :n].float()).abs().max().item()
            assert diff <= TOL[dtype_name], (name, row, diff)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_other_dtypes(cuda):
    args, window, _ = _inputs("mixed", torch.float16, "cuda")
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ragged.ragged_attention_cuda(*args, sliding_window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(DECODE_GEOMETRIES))
def test_cuda_decode_kernel_matches_plain_version(cuda, name, dtype_name):
    args, window = _decode_inputs(name, getattr(torch, dtype_name), "cuda")
    before = paged.launches
    got = paged.paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert paged.launches == before + 1
    assert got.dtype == args[0].dtype
    want = paged.paged_attention_reference(*args, sliding_window=window)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= WAVE_TOL[dtype_name], (name, diff)


@pytest.mark.cuda
def test_cuda_decode_kernel_splits_and_resets_its_counters(cuda):
    """A long bf16 call runs split (8 splits of 256) and leaves its merge
    counters at zero, so a second call on the same stream gives the same
    bits."""
    args, window = _decode_inputs("split_edges_page16", torch.bfloat16, "cuda")
    assert paged.launch_plan(args[0], args[1], args[3]).n_splits == 8
    first = paged.paged_attention(*args, sliding_window=window)
    second = paged.paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(not buf.any().item() for buf in _build._counters.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [3, 4, 7, 8])
@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_cuda_decode_kernel_at_every_head_dim_and_group(cuda, head_dim, group, dtype_name):
    """D in {16, 64, 128} and the groups of models/configs.py (G = 3 .. 8,
    KH = 2) on long rows with a window starting inside a split."""
    args, window = _decode_inputs("window_mid_split", getattr(torch, dtype_name), "cuda",
                                  qh=2 * group, kh=2, d=head_dim)
    got = paged.paged_attention(*args, sliding_window=window)
    want = paged.paged_attention_reference(*args, sliding_window=window)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= WAVE_TOL[dtype_name], (head_dim, group, diff)


def _valid_rows_err(got, want, q_count):
    return max((got[row, :n].float() - want[row, :n].float()).abs().max().item()
               for row, n in enumerate(q_count) if n)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("name", ["mixed", "spec_verify", "window", "ragged_kv_len"])
def test_cuda_bf16_kernel_matches_plain_version_at_every_head_dim(cuda, name, head_dim):
    args, window, q_count = _inputs(name, torch.bfloat16, "cuda", d=head_dim)
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    assert _valid_rows_err(got, want, q_count) <= TOL["bfloat16"], name


#: long rows: name -> (page, pages_per_seq, kv_len, q_count, window).
#: Page 16 x 128 pages: 8 splits of 256 positions, split edges on page
#: edges; page 96 x 22 pages: 9 splits, most edges inside a page.  Rows:
#: a decode row filling the cache, a verify row whose first query is the
#: last position of split 3 (split 4 is all masked for it), a row one past
#: a split edge, a verify row whose window empties splits 0-5, decode rows
#: at a split edge and one position, and an idle row.
LONG_ROWS = {
    "page16": (16, 128, [2048, 1027, 257, 2048, 512, 1, 0], [1, 4, 2, 5, 1, 1, 0], 300),
    "page16_no_window": (16, 128, [2048, 1027, 257, 2000, 512, 1, 0], [1, 4, 2, 5, 1, 1, 0], None),
    "page96": (96, 22, [2112, 1027, 257, 2100, 768, 97, 0], [1, 4, 2, 5, 1, 3, 0], 300),
    "page96_no_window": (96, 22, [2112, 1027, 257, 2100, 768, 97, 0], [1, 4, 2, 5, 1, 3, 0], None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LONG_ROWS))
def test_cuda_kernel_matches_plain_version_on_long_rows(cuda, name, dtype_name):
    page, pps, kv_len, q_count, window = LONG_ROWS[name]
    args, window, q_count = _paged_inputs(kv_len, q_count, window, page, pps, pps + page,
                                          getattr(torch, dtype_name), "cuda")
    if dtype_name == "bfloat16":
        plan = ragged.launch_plan(args[0], args[1], args[3])
        assert plan.n_splits == (8 if page == 16 else 9)
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert ragged.launches == before + 1  # kernel and merge: one wrapper call
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    assert _valid_rows_err(got, want, q_count) <= TOL[dtype_name], name


#: the prefix cache's hit geometry at tinyllama's page 64 and chunk 64:
#: name -> (kv_len, q_count, store-owned head pages per row).  A warm
#: request's first prefill chunk starts where its cached blocks end: 18
#: queries at kv_len 786 over 12 shared pages, beside a longer row over
#: the same 12 pages, a one-block hit, a decode row and an idle row.
HIT_ROWS = {
    "warm_first_chunk": ([786, 850, 130, 65, 0], [18, 64, 2, 1, 0], [12, 12, 2, 0, 0]),
    "full_chunk_after_hit": ([832, 1501, 64 + 64, 1, 0], [64, 64, 64, 1, 0], [12, 22, 1, 0, 0]),
}


def _hit_inputs(name, dtype, device, page=64, pps=32, chunk=64):
    """K1's inputs with rows that share their head pages, as rows that hit
    one cached block chain do: the store's pages first in each table."""
    kv_len, q_count, shared = HIT_ROWS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    b = len(kv_len)
    num_pages = b * pps + 1
    store = list(range(1, 1 + max(shared)))
    own = iter(range(1 + max(shared), num_pages))
    table = np.zeros((b, pps), np.int64)
    for row in range(b):
        table[row, : shared[row]] = store[: shared[row]]
        for j in range(shared[row], pps):
            table[row, j] = next(own, 0)
    arrays = [
        rng.normal(size=(b, chunk, QH, D)).astype(np.float32),
        rng.normal(size=(num_pages, page, KH, D)).astype(np.float32),
        rng.normal(size=(num_pages, page, KH, D)).astype(np.float32),
    ]
    args = [torch.from_numpy(a).to(device, dtype) for a in arrays] + [
        torch.as_tensor(table, dtype=torch.int32, device=device),
        torch.as_tensor(kv_len, dtype=torch.int32, device=device),
        torch.as_tensor(q_count, dtype=torch.int32, device=device),
    ]
    return args, q_count


@pytest.mark.parametrize("name", list(HIT_ROWS))
def test_hit_geometry_shares_head_pages_and_takes_the_plain_version_on_cpu(name):
    args, q_count = _hit_inputs(name, torch.float32, "cpu")
    table, kv_len = args[3], args[4]
    assert torch.equal(table[0, :12], table[1, :12])
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args)
    assert ragged.launches == before
    assert torch.equal(got, ragged.ragged_attention_reference(*args))
    assert int(kv_len[0]) - q_count[0] == 12 * 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(HIT_ROWS))
def test_cuda_kernel_matches_plain_version_at_the_cache_hit_geometry(cuda, name, dtype_name):
    args, q_count = _hit_inputs(name, getattr(torch, dtype_name), "cuda")
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert ragged.launches == before + 1
    want = ragged.ragged_attention_reference(*args)
    assert _valid_rows_err(got, want, q_count) <= TOL[dtype_name], name


def _transfer_pages(dtype, device):
    from types import SimpleNamespace

    rng = np.random.default_rng(5)
    shape = (22, 9, 64, KH, D)  # [layers, pages, page, kv_heads, head_dim]
    k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
            for _ in range(2))
    return SimpleNamespace(k_pages=k, v_pages=v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_page_transfers_match_the_cpu_bytes(cuda, dtype_name):
    """Gather, fetch (side stream, pinned) and restore on the card give
    the CPU's bytes; a write of the gathered page after the gather does
    not reach the fetched copy."""
    from operator_tpu_torch.ops import kv_transfer

    dtype = getattr(torch, dtype_name)
    cpu, card = _transfer_pages(dtype, "cpu"), _transfer_pages(dtype, "cuda")
    want_k, want_v = kv_transfer.fetch_page(*kv_transfer.gather_page(cpu, 5)).wait()
    k_dev, v_dev = kv_transfer.gather_page(card, 5)
    fetch = kv_transfer.fetch_page(k_dev, v_dev)
    card.k_pages[:, 5].fill_(7.0)  # the page's next owner writes, in stream order
    del k_dev, v_dev  # the side stream still holds them
    k_host, v_host = fetch.wait()
    assert k_host.is_pinned() and v_host.is_pinned()
    assert torch.equal(k_host, want_k) and torch.equal(v_host, want_v)
    assert fetch.ready.elapsed_time(fetch.done) >= 0.0
    kv_transfer.restore_page(card, 8, k_host, v_host)
    kv_transfer.restore_page(cpu, 8, want_k, want_v)
    torch.cuda.synchronize()
    cpu.k_pages[:, 5].fill_(7.0)
    assert torch.equal(card.k_pages.cpu(), cpu.k_pages)
    assert torch.equal(card.v_pages.cpu(), cpu.v_pages)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CARD_PREFILL_GEOMETRIES))
def test_cuda_prefill_kernel_matches_plain_version(cuda, name, dtype_name):
    args, window = _prefill_inputs(name, getattr(torch, dtype_name), "cuda")
    before = flash_prefill.launches
    got = flash_prefill.flash_prefill_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    assert got.dtype == args[0].dtype
    want = flash_prefill.flash_prefill_reference(*args, sliding_window=window)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= WAVE_TOL[dtype_name], (name, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("name", ["ragged", "window_no_key", "short_bucket"])
def test_cuda_bf16_prefill_kernel_at_every_head_dim(cuda, name, head_dim):
    """WAVE_TOL plus one bf16 ulp of the output (2^-7 |want|), never above
    K1's 6e-2: rows with one or two keys reach |out| >= 4, where the two
    versions' different rounding of P (normalised or not) can land one
    ulp, 0.03125, apart (measured on D = 32, ``window_no_key``)."""
    args, window = _prefill_inputs(name, torch.bfloat16, "cuda", d=head_dim)
    got = flash_prefill.flash_prefill_attention(*args, sliding_window=window).float()
    want = flash_prefill.flash_prefill_reference(*args, sliding_window=window).float()
    limit = (WAVE_TOL["bfloat16"] + want.abs() * 2.0 ** -7).clamp(max=TOL["bfloat16"])
    excess = (got - want).abs() - limit
    assert excess.max().item() <= 0, (name, head_dim, (got - want).abs().max().item())


@pytest.mark.cuda
def test_cuda_decode_selector_v3_raises(cuda):
    from operator_tpu_torch.serving.provider import build_serving_engine

    env = {
        "OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
        "SCHED_MODE": "wave", "OPERATOR_TPU_PAGED_KERNEL": "v3",
    }
    before = paged.launches
    with pytest.raises(ValueError, match="v3"):
        build_serving_engine("cuda", env)
    assert paged.launches == before


#: best-window similarity: name -> (W, P, D); the three geometries of the
#: semantic path (analysis: 4,096 windows x the 19 built-in patterns; a
#: 1,024-pattern library; recall: one query x 2,048 incidents) and the
#: shapes of tests/test_ops.py
SIM_CASES = {
    "analysis": (4096, 19, 384),
    "library": (4096, 1024, 384),
    "recall": (1, 2048, 384),
    "tiny": (7, 5, 128),
    "ragged_tile": (300, 64, 128),
    "wide": (513, 200, 384),
    "one": (1, 1, 128),
    "recall_small": (1, 300, 128),
    # P off every pattern tile, and W at a share edge: 4,123 windows are
    # 133 shares of 31 on 132 SMs, the last one whole
    "p33_share_edge": (4123, 33, 384),
    "p19_share_edge": (4123, 19, 384),
    "nine_windows": (9, 19, 384),
    "eight_windows": (8, 2048, 384),
    "wide_rows": (1000, 40, 768),
}

#: any embedding width, as the JAX kernel takes: D off 16-byte vectors
#: (100, 385) in both dtypes; rows wider than 4 KB (1,536 f32 = 6 KB,
#: 4,096 bf16 = 8 KB), which take the streaming layout
ANY_D = [(100, "float32"), (100, "bfloat16"), (385, "float32"), (385, "bfloat16"),
         (1536, "float32"), (4096, "bfloat16")]


def _any_d_inputs(w, p, d, dtype_name, duplicated=False):
    """Unit rows on the card; ``duplicated``: pattern j copies one window
    row of the first half, repeated right after it, a tile on and near the
    end, so the first copy (returned) is the only right index."""
    rng = np.random.default_rng(w * 7 + p * 3 + d)
    windows, patterns = _unit_rows(rng, w, d), _unit_rows(rng, p, d)
    firsts = None
    if duplicated:
        firsts = rng.choice(w // 2, size=min(p, w // 2), replace=False)
        for j, first in enumerate(firsts.tolist()):
            for later in {first + 1, first + 129, w - 1 - j}:
                if later < w and later not in firsts:
                    windows[later] = windows[first]
            patterns[j] = windows[first]
    dtype = getattr(torch, dtype_name)
    return (torch.from_numpy(windows).to("cuda", dtype),
            torch.from_numpy(patterns).to("cuda", dtype), firsts)


def _unit_rows(rng, rows, dim):
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _sim_inputs(name, dtype=torch.float32, device="cpu"):
    w, p, d = SIM_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return (
        torch.from_numpy(_unit_rows(rng, w, d)).to(device, dtype),
        torch.from_numpy(_unit_rows(rng, p, d)).to(device, dtype),
    )


def test_similarity_cpu_dispatch_takes_the_plain_version():
    windows, patterns = _sim_inputs("ragged_tile")
    before = similarity.launches
    scores, idx = similarity.best_window_scores(windows, patterns)
    want_s, want_i = similarity.best_window_scores_reference(windows, patterns)
    assert similarity.launches == before
    assert scores.dtype == torch.float32 and idx.dtype == torch.int32
    assert torch.equal(scores, want_s) and torch.equal(idx, want_i)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        similarity.best_window_scores_cuda(windows, patterns)
    assert similarity.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SIM_CASES))
def test_cuda_similarity_kernel_matches_plain_version(cuda, name, dtype_name):
    """Scores within 1e-5 in both dtypes (bf16 inputs are widened exactly
    and the products summed in f32; only the order of the sums differs);
    the index is checked by the plain score at the chosen window."""
    windows, patterns = _sim_inputs(name, getattr(torch, dtype_name), "cuda")
    before = similarity.launches
    scores, idx = similarity.best_window_scores(windows, patterns)
    torch.cuda.synchronize()
    assert similarity.launches == before + 1
    assert scores.shape == idx.shape == (patterns.shape[0],)
    want_s, _ = similarity.best_window_scores_reference(windows, patterns)
    matrix = similarity.similarity_matrix(windows, patterns)
    chosen = matrix[idx.long(), torch.arange(patterns.shape[0], device="cuda")]
    assert (scores - want_s).abs().max().item() <= 1e-5
    assert (chosen - want_s).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["analysis", "library", "ragged_tile", "p33_share_edge",
                                  "p19_share_edge", "nine_windows", "wide_rows"])
def test_cuda_similarity_kernel_takes_the_first_of_equal_windows(cuda, name, dtype_name):
    """Each pattern is a copy of one window row, and that row appears again
    later (in the same tile, the next tile and the last share): the kernel
    must return the first copy, exactly as the plain version does."""
    windows, patterns = _sim_inputs(name, getattr(torch, dtype_name), "cuda")
    w, p = windows.shape[0], patterns.shape[0]
    rng = np.random.default_rng(7)
    firsts = rng.choice(w // 2, size=min(p, w // 2), replace=False)
    for j, first in enumerate(firsts.tolist()):
        # the next row, the next tile of 32, 64 and 128 rows, the last share
        for later in {first + 1, first + 31, first + 32, first + 65, first + 128, w - 1 - j}:
            if later < w and later not in firsts:
                windows[later] = windows[first]
        patterns[j] = windows[first]
    scores, idx = similarity.best_window_scores(windows, patterns)
    want_s, _ = similarity.best_window_scores_reference(windows, patterns)
    torch.cuda.synchronize()
    # against the known first copy, not the plain version's index: cuBLAS
    # may score equal rows a last bit apart in different tiles
    assert torch.equal(idx[: len(firsts)].cpu(), torch.as_tensor(firsts, dtype=torch.int32))
    assert (scores - want_s).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("p", [19, 1024])
@pytest.mark.parametrize("w", [1, 4096])
@pytest.mark.parametrize("d,dtype_name", ANY_D, ids=[f"{d}-{t}" for d, t in ANY_D])
def test_cuda_similarity_kernel_takes_any_width(cuda, d, dtype_name, w, p):
    """Any D, as the JAX kernel: scores within 1e-5 of the plain version
    and the plain score at the chosen window, one launch; at 4,096 windows
    also the first of equal windows, exactly."""
    for duplicated in (False, True) if w > 1 else (False,):
        windows, patterns, firsts = _any_d_inputs(w, p, d, dtype_name, duplicated)
        before = similarity.launches
        scores, idx = similarity.best_window_scores(windows, patterns)
        torch.cuda.synchronize()
        assert similarity.launches == before + 1
        want_s, _ = similarity.best_window_scores_reference(windows, patterns)
        matrix = similarity.similarity_matrix(windows, patterns)
        chosen = matrix[idx.long(), torch.arange(p, device="cuda")]
        assert (scores - want_s).abs().max().item() <= 1e-5
        assert (chosen - want_s).abs().max().item() <= 1e-5
        if firsts is not None:
            assert torch.equal(idx[: len(firsts)].cpu(), torch.as_tensor(firsts, dtype=torch.int32))


@pytest.mark.cuda
def test_cuda_similarity_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    windows, patterns = _sim_inputs("tiny", torch.float32, "cuda")
    before = similarity.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        similarity.best_window_scores(windows, patterns.cpu())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        similarity.best_window_scores(windows.cpu(), patterns)
    with pytest.raises(TypeError, match="dtype"):
        similarity.best_window_scores(windows, patterns.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        similarity.best_window_scores(windows[:, ::2], patterns[:, ::2])
    with pytest.raises(ValueError, match="at least one window"):
        similarity.best_window_scores(windows[:0], patterns)
    assert similarity.launches == before


#: a ``tiny-test`` model with room for the committed tokenizer fixture's
#: 1,405 ids and the default prompt template (its prompts of the fixture
#: logs are under 1,500 of that tokenizer's tokens)
CHECKPOINT_MODEL = "tiny-test-sp"
TOKENIZER_FIXTURE = Path(__file__).resolve().parent / "torch_tokenizers" / "llama_sp"


def _seeded_checkpoint(path, monkeypatch) -> dict:
    """Seeded bf16 ``CHECKPOINT_MODEL`` weights written by the port's own
    ``save_params`` (no ``transformers`` here), with the committed
    tokenizer; the model registered for ``build_serving_engine``."""
    import dataclasses
    import shutil

    from operator_tpu_torch.models import configs
    from operator_tpu_torch.models.llama import init_params
    from operator_tpu_torch.models.loader import save_params

    config = dataclasses.replace(
        configs.TINY_TEST, name=CHECKPOINT_MODEL, vocab_size=1536, max_seq_len=2048)
    monkeypatch.setitem(configs._REGISTRY, CHECKPOINT_MODEL, config)
    params = init_params(config, torch.Generator().manual_seed(0), torch.bfloat16, device="cpu")
    save_params(params, str(path), config, shard_bytes=1 << 20)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(TOKENIZER_FIXTURE / name, path / name)
    return {"config": config, "params": params}


def _trees_equal_bytes(a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_trees_equal_bytes(a[k], b[k]) for k in a)
    a, b = a.cpu(), b.cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _provider_request(name: str):
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.schema.analysis import (
        AIProviderConfig,
        AnalysisRequest,
        PodFailureData,
    )

    logs = (Path(__file__).resolve().parent / "fixtures" / name).read_text()
    failure = PodFailureData.parse({"logs": logs, "pod": {
        "metadata": {"name": name.split(".")[0].replace("_", "-"), "namespace": "prod"}}})
    return AnalysisRequest(
        analysis_result=PatternEngine().analyze(failure), failure_data=failure,
        provider_config=AIProviderConfig(max_tokens=6, temperature=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
def test_cuda_load_params_equals_the_cpu_load(cuda, tmp_path, monkeypatch, quantize):
    from operator_tpu_torch.models.loader import load_params

    config = _seeded_checkpoint(tmp_path, monkeypatch)["config"]
    on_card = load_params(str(tmp_path), config, device="cuda", quantize=quantize)
    on_cpu = load_params(str(tmp_path), config, device="cpu", quantize=quantize)
    assert on_card["embed"].is_cuda
    assert _trees_equal_bytes(on_card, on_cpu)


@pytest.mark.cuda
def test_cuda_provider_launches_the_ragged_kernel(cuda, tmp_path, monkeypatch):
    import asyncio

    from operator_tpu_torch.models.tokenizer import HFTokenizer
    from operator_tpu_torch.serving.provider import build_tpu_native_provider

    _seeded_checkpoint(tmp_path, monkeypatch)
    provider = build_tpu_native_provider("cuda", {
        "OPERATOR_TPU_MODEL": CHECKPOINT_MODEL, "CHECKPOINT_DIR": str(tmp_path),
        "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16"})
    try:
        assert isinstance(provider.engine.generator.tokenizer, HFTokenizer)
        before = ragged.launches
        response = asyncio.run(provider.generate(_provider_request("oom_java.log")))
        assert response.error is None and response.completion_tokens > 0
        assert ragged.launches > before
    finally:
        provider.engine.close()


@pytest.mark.cuda
def test_cuda_operator_demo_launches_k1_per_step_and_k5_per_analysis(cuda, monkeypatch):
    """``run_demo(provider_id="tpu-native")`` on the card (its default
    device) at ``tiny-test``'s widths with a 2,048-token context (random
    weights, byte tokenizer) and a tiny encoder: the pod is analysed and
    stored, K1 launched once per layer per engine step and K5 once, for
    the one semantic ``analyze()`` (the recall index is still empty)."""
    import asyncio
    import dataclasses
    import functools

    from operator_tpu_torch.models import configs
    from operator_tpu_torch.models.encoder import ENCODER_TINY_TEST, init_encoder_params
    from operator_tpu_torch.operator import app
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher
    from operator_tpu_torch.serving import provider as provider_module
    from operator_tpu_torch.utils.config import OperatorConfig

    name = "tiny-test-demo"
    cfg = dataclasses.replace(configs.TINY_TEST, name=name, max_seq_len=2048)
    monkeypatch.setitem(configs._REGISTRY, name, cfg)
    monkeypatch.setattr(app, "OperatorConfig", functools.partial(
        OperatorConfig, model_id=name, allow_random_weights=True, max_batch_size=4,
        kv_page_size=16))
    monkeypatch.delenv("OPERATOR_TPU_MODEL", raising=False)
    params = init_encoder_params(ENCODER_TINY_TEST, torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
    monkeypatch.setattr(app.Operator, "_build_semantic", lambda self: SemanticMatcher(
        NeuralEmbedder(params, ENCODER_TINY_TEST, lambda t: [b % 512 for b in t.encode()],
                       device=self.device), device=self.device))
    built = []
    build = provider_module.build_tpu_native_provider
    monkeypatch.setattr(provider_module, "build_tpu_native_provider",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    ragged.launches = similarity.launches = 0
    try:
        summary = asyncio.run(app.run_demo(provider_id="tpu-native"))
        [provider] = built
        steps = provider.engine.scheduler.steps
        assert ragged.launches == cfg.num_layers * steps and steps > 0
        assert similarity.launches == 1
        status = summary["podmortem_status"]["recentFailures"][0]
        assert status["analysisStatus"] == "Analyzed" and status["explanation"]
        assert summary["metrics"]["counters"].get("provider_errors") is None
    finally:
        for provider in built:
            provider.engine.close()


#: llama-3-8b's heads: 32 query heads over 8 KV heads of 128
LLAMA3_HEADS = {"qh": 32, "kh": 8, "d": 128}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GEOMETRIES) + list(LONG_ROWS))
def test_cuda_kernel_matches_plain_version_at_llama3_heads(cuda, name, dtype_name):
    """K1 at D = 128 with a group of 4, the instantiation the deployed
    model launches, on every short geometry and the long rows."""
    if name in GEOMETRIES:
        kv_len, q_count, window = GEOMETRIES[name]
        page, pps = PAGE, PPS
    else:
        page, pps, kv_len, q_count, window = LONG_ROWS[name]
    args, window, q_count = _paged_inputs(kv_len, q_count, window, page, pps, 128 + pps,
                                          getattr(torch, dtype_name), "cuda", **LLAMA3_HEADS)
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert ragged.launches == before + 1
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    assert _valid_rows_err(got, want, q_count) <= TOL[dtype_name], name


#: the other families' heads, D = 128: qwen2.5-7b's group of 7,
#: llama-3.2-3b's of 3 and qwen2.5-1.5b's of 6 (a 64-row tile then cuts a
#: token's heads)
FAMILY_HEADS = {
    "g7": {"qh": 28, "kh": 4, "d": 128},
    "g3": {"qh": 24, "kh": 8, "d": 128},
    "g6": {"qh": 12, "kh": 2, "d": 128},
}
#: chunks of 64 queries (tiles of 64 flash rows end inside a token at
#: groups of 7, 3 and 6): name -> (page, pages_per_seq, kv_len, q_count,
#: window); a whole first chunk, a chunk after cached pages, a decode row,
#: a short prompt, an idle row
CHUNK_ROWS = {
    "chunks": (16, 16, [64, 250, 131, 9, 0], [64, 64, 1, 9, 0], None),
    "chunks_window": (16, 16, [64, 250, 131, 9, 0], [64, 64, 1, 9, 0], 40),
}


def _family_inputs(heads, name, dtype, device):
    if name in CHUNK_ROWS:
        page, pps, kv_len, q_count, window = CHUNK_ROWS[name]
        c = 64
    else:
        page, pps, kv_len, q_count, window = LONG_ROWS[name]
        c = C
    return _paged_inputs(kv_len, q_count, window, page, pps, 256 + pps + len(heads), dtype,
                         device, c=c, **FAMILY_HEADS[heads])


@pytest.mark.parametrize("name", list(CHUNK_ROWS))
@pytest.mark.parametrize("heads", list(FAMILY_HEADS))
def test_family_heads_take_the_plain_version_on_cpu(heads, name):
    args, window, _ = _family_inputs(heads, name, torch.float32, "cpu")
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    assert ragged.launches == before
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    assert torch.equal(got, ragged.ragged_attention_reference(*args, sliding_window=window))


def test_ragged_split_plan_at_the_families_contexts():
    """Mistral's 8,192 positions cut into 16 splits of 512, the 16,384 of
    Qwen2.5 and Llama-3.2 into 16 of 1,024; at mistral-7b's serve shapes
    (32 rows, chunk 64, 32 q heads over 8 KV heads of 128, 128 pages of
    64) the scratch holds 16 partials of 64 rows per row and KV head."""
    assert ragged.split_plan(8192) == (16, 512)
    assert ragged.split_plan(16384) == (16, 1024)
    plan = ragged.launch_plan(_meta((32, 64, 32, 128), torch.bfloat16),
                              _meta((4097, 64, 8, 128), torch.bfloat16),
                              _meta((32, 128), torch.int32))
    assert (plan.n_splits, plan.split_keys) == (16, 512)
    assert plan.acc_shape == (32, 8, 16, 64, 128) and plan.ml_shape == (32, 8, 16, 64, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CHUNK_ROWS) + list(LONG_ROWS))
@pytest.mark.parametrize("heads", list(FAMILY_HEADS))
def test_cuda_kernel_matches_plain_version_at_the_families_heads(cuda, heads, name, dtype_name):
    """K1 at groups of 7, 3 and 6 with D = 128, on 64-query chunks whose
    tiles split a token's heads and on the long rows."""
    args, window, q_count = _family_inputs(heads, name, getattr(torch, dtype_name), "cuda")
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert ragged.launches == before + 1
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    assert _valid_rows_err(got, want, q_count) <= TOL[dtype_name], name


#: mistral-7b's 4,096-token window over its 8,192 positions (128 pages of
#: 64): rows at 4,097 (one key before the window), 8,192, a verify row and
#: a 64-token chunk past the window, a decode row inside it, an idle row
MISTRAL_ROWS = ([4097, 8192, 6001, 5000, 3000, 0], [1, 1, 5, 64, 1, 0])
MISTRAL_WINDOW = 4096
#: a query under the window averages up to 4,096 random V rows (outputs
#: about 0.03, far below the magnitude TOL and WAVE_TOL are stated for),
#: so these cases also hold each query row (its heads and D): its largest
#: error over its largest |plain|, in bf16 2.5 ulps of that output
ROW_TOL = {"float32": 1e-4 / 3, "bfloat16": 2e-2}


def _row_scaled_err(got, want):
    """The largest, over query rows, of a row's max |got - want| over its
    max |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().flatten(-2).amax(-1)
    return (diff / want.abs().flatten(-2).amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_kernels_under_a_4096_window_over_8192_positions(cuda, dtype_name):
    """K1 (tile 0 in 16 splits of 512, the first ones wholly before a
    row's window), the decode kernel K2/K3 on the same rows and the
    prefill kernel K4 at T = 8,192, each at mistral-7b's heads under its
    window, against the plain versions."""
    dtype = getattr(torch, dtype_name)
    kv_len, q_count = MISTRAL_ROWS
    args, window, q_count = _paged_inputs(kv_len, q_count, MISTRAL_WINDOW, 64, 128, 8192,
                                          dtype, "cuda", c=64, **LLAMA3_HEADS)
    if dtype_name == "bfloat16":
        plan = ragged.launch_plan(args[0], args[1], args[3])
        assert (plan.n_splits, plan.split_keys) == (16, 512)
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert ragged.launches == before + 1
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    assert _valid_rows_err(got, want, q_count) <= TOL[dtype_name]
    valid = torch.arange(64, device="cuda")[None, :] < args[5][:, None]
    assert _row_scaled_err(got[valid], want[valid]) <= ROW_TOL[dtype_name]
    # the decode kernel: each row's last query over the same pages
    lengths = torch.clamp(args[4], min=1)
    q = args[0][:, 0].contiguous()
    got = paged.paged_attention_cuda(q, args[1], args[2], args[3], lengths,
                                     sliding_window=MISTRAL_WINDOW)
    want = paged.paged_attention_reference(q, args[1], args[2], args[3], lengths,
                                           sliding_window=MISTRAL_WINDOW)
    assert (got.float() - want.float()).abs().max().item() <= WAVE_TOL[dtype_name]
    assert _row_scaled_err(got, want) <= ROW_TOL[dtype_name]
    del args, got, want
    # the prefill kernel over one 8,192-token row
    rng = np.random.default_rng(8192)
    arrays = [rng.normal(size=(1, 8192, h, 128)).astype(np.float32) for h in (32, 8, 8)]
    pre = [torch.from_numpy(a).to("cuda", dtype) for a in arrays] + [
        torch.tensor([8192], dtype=torch.int32, device="cuda")]
    got = flash_prefill.flash_prefill_cuda(*pre, sliding_window=MISTRAL_WINDOW)
    want = flash_prefill.flash_prefill_reference(*pre, sliding_window=MISTRAL_WINDOW)
    assert (got.float() - want.float()).abs().max().item() <= WAVE_TOL[dtype_name]
    assert _row_scaled_err(got, want) <= ROW_TOL[dtype_name]


@pytest.mark.cuda
def test_cuda_supervised_restart_leaves_no_device_memory_behind(cuda):
    """A continuous engine on the card whose step stalls past a tightened
    budget: the supervisor abandons the step, frees the old page pool
    before it allocates the new one, requeues the request, and once it
    finishes the device memory is back at its level before the stall."""
    import asyncio

    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.serving.types import SamplingParams
    from operator_tpu_torch.utils.faultinject import OK, FaultPlan, sleep_

    engine, _ = build_serving_engine("cuda", {
        "OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
        "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16"})
    g = engine.generator
    try:
        engine.warmup()
        greedy = SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False)
        want = asyncio.run(engine.generate("stalled mid-decode then requeued", greedy))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        pool = g.paged_cache
        engine._supervisor.stall_timeout_s = 0.5
        plan = FaultPlan(seed=5)
        plan.rule("engine.step", [OK, sleep_(1.5)])
        g.fault_plan = plan
        got = asyncio.run(asyncio.wait_for(
            engine.generate("stalled mid-decode then requeued", greedy), 30))
        g.fault_plan = None
        del pool
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        assert g.metrics.counter("supervisor_restart") == 1
        assert g.metrics.counter("supervisor_requeue") == 1
        assert got.token_ids == want.token_ids
        assert after <= before + (1 << 20), (before, after)
        # no row holds a page; the prefix cache keeps the prompt's blocks
        acc = engine.scheduler.page_accounting()
        assert acc["row_pages"] == 0
        assert acc["available"] + acc["store_pages"] + acc["prefix_pages"] == acc["total"]
    finally:
        engine.close()


@pytest.mark.cuda
def test_cuda_page_through_the_wire_restores_byte_for_byte_on_a_second_engine(cuda):
    """Two continuous engines on the card: A mirrors a prompt's blocks
    (gathered on the card into its pinned pool), B prefetches them through
    the PMKV1 wire and restores them; each restored page is A's device
    page byte for byte and B's greedy tokens are A's when A restores the
    same blocks from its own pool."""
    import asyncio

    from operator_tpu_torch.fabric import FabricIndex
    from operator_tpu_torch.serving.kvstore import block_hashes
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.serving.types import SamplingParams

    env = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
           "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16", "KV_FABRIC": "true",
           "KV_HOST_POOL_MB": "16"}
    engine_a, _ = build_serving_engine("cuda", {**env, "SERVING_REPLICA_ID": "a"})
    engine_b, _ = build_serving_engine("cuda", {**env, "SERVING_REPLICA_ID": "b"})
    prompt = "the quick brown fox jumps over the lazy dog " * 2
    greedy = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)
    try:
        for engine in (engine_a, engine_b):
            engine.warmup()
        asyncio.run(engine_a.generate(prompt, greedy))
        # like for like: A restores the same blocks from its own pool, so
        # both engines run the same chunks (K1's split rounds by a chunk's
        # place)
        engine_a.store_executor.submit(engine_a.scheduler.spill_cache).result(30)
        want = asyncio.run(engine_a.generate(prompt, greedy))
        assert engine_a.generator.metrics.counter("kv_restore") == 5
        hashes = block_hashes(engine_a.generator.tokenizer.encode(prompt), 16)
        index = FabricIndex()
        index.update("a", [h.hex() for h in hashes], url="http://a")

        async def transport(url, budget_s):
            data = engine_a.kv_block_bytes(url.rsplit("/", 1)[-1])
            return (404, b"") if data is None else (200, data)

        engine_b.fabric.index, engine_b.fabric._transport = index, transport
        got = asyncio.run(engine_b.generate(prompt, greedy))
        metrics = engine_b.generator.metrics
        assert metrics.counter("fabric_prefetch_adopted") == len(hashes) == 5
        assert metrics.counter("kv_restore") == len(hashes)
        assert got.token_ids == want.token_ids
        cache_a, cache_b = engine_a.generator.paged_cache, engine_b.generator.paged_cache
        for h in hashes:
            page_a = engine_a.scheduler._kvstore.get(h).page
            page_b = engine_b.scheduler._kvstore.get(h).page
            assert page_a >= 0 and page_b >= 0
            assert torch.equal(cache_a.k_pages[:, page_a], cache_b.k_pages[:, page_b])
            assert torch.equal(cache_a.v_pages[:, page_a], cache_b.v_pages[:, page_b])
    finally:
        engine_a.close()
        engine_b.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_kernel_over_a_page_restored_from_the_wire_matches_plain_version(
        cuda, dtype_name):
    """K1 at llama-3-8b's heads (D = 128, group 4, page 64) over a page
    gathered from another cache on the card, sent through the PMKV1 wire
    and restored: the restored page is the sender's byte for byte, and the
    kernel agrees with the plain version on every valid row."""
    from types import SimpleNamespace

    from operator_tpu_torch.fabric import decode_block, encode_block
    from operator_tpu_torch.ops import kv_transfer

    dtype = getattr(torch, dtype_name)
    kv_len, q_count = [700, 129, 64, 1], [1, 5, 8, 1]
    args, window, q_count = _paged_inputs(kv_len, q_count, None, 64, 12, 31, dtype, "cuda",
                                          **LLAMA3_HEADS)
    rng = np.random.default_rng(9)
    sender = SimpleNamespace(**{
        name: torch.from_numpy(rng.normal(size=(1, 8, 64, 8, 128)).astype(np.float32))
        .to("cuda", dtype) for name in ("k_pages", "v_pages")})
    k_host, v_host = kv_transfer.fetch_page(*kv_transfer.gather_page(sender, 5)).wait()
    _h, k, v = decode_block(encode_block(b"\x07" * 16, k_host, v_host))
    receiver = SimpleNamespace(k_pages=args[1][None], v_pages=args[2][None])
    for row in range(3):  # the page each of the long rows reads first
        kv_transfer.restore_page(receiver, int(args[3][row, 0]), k, v)
    torch.cuda.synchronize()
    target = int(args[3][0, 0])
    assert torch.equal(args[1][target], sender.k_pages[0, 5])
    assert torch.equal(args[2][target], sender.v_pages[0, 5])
    before = ragged.launches
    got = ragged.ragged_paged_attention(*args, sliding_window=window)
    torch.cuda.synchronize()
    assert ragged.launches == before + 1
    want = ragged.ragged_attention_reference(*args, sliding_window=window)
    assert _valid_rows_err(got, want, q_count) <= TOL[dtype_name]
