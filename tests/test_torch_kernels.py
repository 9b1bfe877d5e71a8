"""The port's kernels: plain versions against numpy, wrapper checks,
and (on a CUDA card only) each kernel against its plain version.

K1, its verifying pass ``stream_increment_verify_`` and K2 are held
exactly: an fp32 add, a min, a max and an absolute
difference round the same way in numpy and PyTorch, and the kernels
compute the same operations.  K3 (``block_attention``) is held on the
card within the tolerances ``chip_smoke.py`` states for it: m 1e-4
absolute, l 1e-4 relative, num 5e-2 absolute (bf16 rounding of p after
fp32 sums taken in another order); so is its fused ring step
``block_attention_merge_`` against ``block_attention_merge_plain``, whose
merge must also equal ``merge_plain`` applied on the card to the
kernel's own ``(num, m, l)`` bit for bit.  Their plain versions are held
against the JAX package in ``tests/test_torch_ring_attention.py``.  K4
(``peer_reduce``) is held on the card bit for bit: fp32 adds in index
order and an IEEE division in both; its plain version and the
collectives built on it are held against the JAX package in
``tests/test_torch_collectives.py``.  K5 (``peer_gather``) is a byte
copy, held on the card byte for byte, and so are the all-gather and the
all-reduce round it carries.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

from k8s_operator_libs_tpu_torch.kernels import (  # noqa: E402
    all_gather,
    all_reduce,
    all_reduce_init,
    block_attention,
    block_attention_merge_,
    block_attention_merge_plain,
    block_attention_plain,
    build,
    collectives,
    launch_counts,
    merge_plain,
    peer_gather,
    peer_gather_plain,
    peer_reduce,
    peer_reduce_plain,
    ring_shift,
    stream_increment_,
    stream_increment_plain_,
    stream_increment_verify_,
    stream_increment_verify_plain_,
    verify_stats,
    verify_stats_plain,
)
from k8s_operator_libs_tpu_torch.kernels import battery  # noqa: E402

SIZES = [1, 7, 4096, 1_000_003]
# K3's card cases: (B, Sq, Sk, H, D), q_offset, k_offset, causal.
K3_CARD_CASES = [
    ((1, 128, 128, 4, 64), 384, 0, True),
    ((1, 128, 128, 4, 64), 384, 384, True),
    ((1, 128, 128, 4, 64), 384, 640, True),  # wholly masked
    # The elastic ring's shards (D 32) and its full reference.
    ((1, 64, 64, 2, 32), 192, 0, True),
    ((1, 64, 64, 2, 32), 192, 192, True),
    ((1, 64, 64, 2, 32), 192, 320, True),
    ((1, 512, 512, 2, 32), 0, 0, True),
    ((2, 100, 100, 3, 16), 0, 0, True),
    ((1, 70, 90, 2, 8), 5, 0, True),
    ((2, 128, 192, 4, 64), 0, 0, False),
    ((1, 96, 80, 2, 128), 16, 0, True),
    # Head dims whose rows the block's threads do not tile evenly (D
    # padded to 48, 80, 96 and 112), ragged and non-causal among them.
    ((1, 70, 90, 2, 40), 5, 0, True),
    ((2, 100, 77, 3, 72), 30, 0, True),
    ((1, 64, 64, 2, 96), 10, 0, True),
    ((1, 96, 130, 2, 104), 0, 0, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; torch's default of one
    # intra-op thread per core oversubscribes the host and slows the
    # CPU reductions here for every worker.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_stats(a: np.ndarray, center: float) -> np.ndarray:
    a = a.astype(np.float32)
    return np.array(
        [a.min(), a.max(), np.abs(a - np.float32(center)).max()],
        dtype=np.float32,
    )


def _same(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_array_equal(got, want)  # NaN == NaN here


@pytest.mark.parametrize("n", SIZES)
def test_stream_increment_cpu_matches_numpy(n):
    host = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x = torch.from_numpy(host.copy())
    before = launch_counts()
    for _ in range(3):
        assert stream_increment_(x) is x  # in place
    _same(x.numpy(), host + np.float32(1) + np.float32(1) + np.float32(1))
    # The CPU path is the plain version: no kernel launch is counted.
    assert launch_counts() == before


@pytest.mark.parametrize("nan_at", [None, "first", "last"])
@pytest.mark.parametrize("center", [0.0, 0.5])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", SIZES)
def test_stream_increment_verify_cpu_matches_numpy(n, offset, center,
                                                   nan_at):
    host = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    if nan_at is not None:
        host[0 if nan_at == "first" else -1] = np.nan
    # An unaligned view when offset is 1, as the card's scalar head sees.
    x = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32),
                                         host]))[offset:]
    before = launch_counts()
    got = stream_increment_verify_(x, center)
    bumped = host + np.float32(1)
    _same(x.numpy(), bumped)  # in place
    assert got.dtype == torch.float32 and got.shape == (3,)
    _same(got.numpy(), _numpy_stats(bumped, center))
    if nan_at is not None:
        assert np.isnan(got.numpy()).all()
    # The CPU path is the plain version: no kernel launch is counted.
    assert launch_counts() == before


def test_stream_increment_verify_plain_is_a_pass_then_the_check():
    x = torch.zeros(1_000_003)
    for _ in range(7):
        stream_increment_plain_(x)
    got = stream_increment_verify_plain_(x, 0.0)
    assert got.tolist() == [8.0, 8.0, 8.0]
    assert torch.equal(got, verify_stats_plain(x, 0.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("center", [0.0, 0.5])
def test_verify_stats_cpu_matches_numpy(n, dtype, center):
    host = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x = torch.from_numpy(host).to(getattr(torch, dtype))
    want = _numpy_stats(x.float().numpy(), center)
    got = verify_stats(x, center)
    assert got.dtype == torch.float32 and got.shape == (3,)
    _same(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", [0, 3, 1_000_002])
def test_verify_stats_propagates_nan(dtype, where):
    x = torch.full((1_000_003,), 0.5).to(getattr(torch, dtype))
    x[where] = float("nan")
    assert torch.isnan(verify_stats(x, 0.5)).all()


def test_verify_stats_seeded_quarter():
    c = torch.full((128, 128), 0.5, dtype=torch.bfloat16)
    c[17, 33] = 0.25
    assert verify_stats(c, 0.5).tolist() == [0.25, 0.5, 0.25]


def test_stream_increment_plain_counts_passes():
    x = torch.zeros(1_000_003)
    for _ in range(8):
        stream_increment_plain_(x)
    assert verify_stats_plain(x, 0.0).tolist() == [8.0, 8.0, 8.0]


@pytest.mark.parametrize(
    "fn, bad",
    [
        (stream_increment_, lambda: torch.zeros(8, dtype=torch.float64)),
        (stream_increment_, lambda: torch.zeros(8, dtype=torch.bfloat16)),
        (verify_stats, lambda: torch.zeros(8, dtype=torch.float16)),
        (verify_stats, lambda: torch.zeros(8, dtype=torch.int32)),
        (stream_increment_verify_,
         lambda: torch.zeros(8, dtype=torch.float64)),
        (stream_increment_verify_,
         lambda: torch.zeros(8, dtype=torch.bfloat16)),
    ],
)
def test_wrappers_reject_wrong_dtype(fn, bad):
    with pytest.raises(TypeError):
        fn(bad()) if fn is stream_increment_ else fn(bad(), 0.0)


@pytest.mark.parametrize(
    "bad",
    [
        lambda: torch.zeros(16)[::2],
        lambda: torch.zeros(4, 4).t(),
        lambda: torch.zeros(0),
    ],
    ids=["strided", "transposed", "empty"],
)
@pytest.mark.parametrize("which", ["stream_increment_", "verify_stats",
                                   "stream_increment_verify_"])
def test_wrappers_reject_noncontiguous_and_empty(bad, which):
    with pytest.raises(ValueError):
        if which == "stream_increment_":
            stream_increment_(bad())
        elif which == "verify_stats":
            verify_stats(bad(), 0.0)
        else:
            stream_increment_verify_(bad(), 0.0)


def test_build_targets_sm90a_and_binds_every_entry_point():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert [p.name for p in build.SOURCES] == [
        "attention_kernels.cu", "battery_kernels.cu", "collective_kernels.cu",
    ]
    src = "".join(p.read_text() for p in build.SOURCES)
    for symbol in (
        "battery_stream_increment",
        "battery_stream_increment_verify_f32",
        "battery_verify_scratch_floats",
        "battery_verify_stats_f32",
        "battery_verify_stats_bf16",
        "battery_error_string",
        "attention_block_f32",
        "attention_block_merge_f32",
        "collective_peer_enable",
        "collective_peer_reduce",
        "collective_peer_gather",
        "collective_plan_create",
        "collective_plan_launch",
        "collective_plan_nodes",
    ):
        assert f"{symbol}(" in src
    # K4's cap on sources has one value on both sides of the binding, and
    # so have K1's tiles.
    assert (
        f"constexpr int kMaxSources = {collectives.MAX_SOURCES};" in src
    )
    assert f"constexpr int kStreamVecs = {battery.STREAM_VECS};" in src
    assert f"constexpr int kVerifyVecs = {battery.VERIFY_VECS};" in src
    # The build writes into a directory git ignores.
    ignored = (build.BUILD_DIR.parents[1] / ".gitignore").read_text()
    assert "build/torch_kernels/" in ignored.split()


# -- where the kernel library lives ----------------------------------------
# A stub ``nvcc`` writes each ``-o`` file and logs its call; nothing it
# writes is loaded.
_STUB_NVCC = """#!/bin/sh
echo "$@" >> "${0%/*}/calls.log"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo stub > "$2"; fi
  shift
done
"""


def _stub_nvcc(tmp_path: Path) -> Path:
    """A directory holding the stub ``nvcc``; its calls go to
    ``calls.log`` there."""
    bin_dir = tmp_path / "stub-bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_STUB_NVCC)
    nvcc.chmod(0o755)
    return bin_dir


def _stub_calls(bin_dir: Path) -> int:
    log = bin_dir / "calls.log"
    return len(log.read_text().splitlines()) if log.exists() else 0


@pytest.fixture
def installed(tmp_path):
    """The port laid out as its wheel installs it, read-only: phase 18's
    copy (``chip_smoke.lay_out_install``)."""
    site = tmp_path / "site"
    chip_smoke.lay_out_install(site)
    chip_smoke.set_read_only(site, True)
    yield site
    chip_smoke.set_read_only(site, False)


def _copied_build(site: Path):
    """The install's ``kernels/build.py`` as a module of its own (it
    imports nothing of the package)."""
    path = site / "k8s_operator_libs_tpu_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location("_installed_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _no_kernel_env(monkeypatch, tmp_path):
    monkeypatch.delenv(build.KERNEL_DIR_ENV, raising=False)
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))


def test_the_build_entry_writes_only_into_the_kernel_directory(
        tmp_path, installed):
    """``python -m ...kernels.build`` from a read-only install compiles
    the library into the configured directory, named by the digest of
    the sources and flags, and leaves the install byte for byte as it
    was; run again, it finds the library and compiles nothing."""
    bin_dir = _stub_nvcc(tmp_path)
    kernels = tmp_path / "kernels"
    before = chip_smoke.tree_digest(installed)
    env = {**os.environ, build.KERNEL_DIR_ENV: str(kernels),
           "PYTHONPATH": str(installed), "PYTHONDONTWRITEBYTECODE": "1",
           "PATH": os.pathsep.join([str(bin_dir), os.environ["PATH"]])}
    want = kernels / f"libport_kernels-{build._digest()}.so"
    for calls in (len(build.SOURCES) + 1, len(build.SOURCES) + 1):
        proc = subprocess.run(
            [sys.executable, "-m", build.ENTRY], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split()[0] == str(want)
        # One nvcc a source and the link, the first time only.
        assert _stub_calls(bin_dir) == calls
    assert sorted(p.name for p in kernels.iterdir()) == [want.name]
    assert chip_smoke.tree_digest(installed) == before
    assert not any(installed.rglob("*.so"))


def test_a_second_load_finds_the_built_library(tmp_path, installed,
                                               monkeypatch):
    """``load_library`` resolves the library the build entry made (the
    same digest-named file) and runs ``nvcc`` no more."""
    bin_dir = _stub_nvcc(tmp_path)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setenv(build.KERNEL_DIR_ENV, str(tmp_path / "kernels"))
    mod = _copied_build(installed)
    built = mod.build_library()
    assert _stub_calls(bin_dir) == len(build.SOURCES) + 1
    loaded = []
    monkeypatch.setattr(mod, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: loaded.append(path) or path))
    monkeypatch.setattr(mod, "_bind", lambda lib: lib)
    assert mod.load_library() == str(built)
    assert loaded == [str(built)]
    assert _stub_calls(bin_dir) == len(build.SOURCES) + 1


@pytest.mark.parametrize("cache", ["home", "xdg"])
def test_an_install_s_default_kernel_directory_is_the_user_s(
        tmp_path, installed, monkeypatch, cache):
    """Outside a checkout, with no kernel directory configured, the
    library goes to the user's cache: writable, and not in the install."""
    _no_kernel_env(monkeypatch, tmp_path)
    if cache == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    bin_dir = _stub_nvcc(tmp_path)
    monkeypatch.setenv("PATH", str(bin_dir))
    mod = _copied_build(installed)
    assert not mod.in_checkout()
    base = tmp_path / ("home/.cache" if cache == "home" else "xdg")
    assert mod.kernel_dir() == base / "k8s_operator_libs_tpu_torch" / "kernels"
    built = mod.build_library()
    assert built.parent == mod.kernel_dir() and built.is_file()
    assert installed not in built.parents


def test_a_checkout_keeps_its_kernel_directory(tmp_path, monkeypatch):
    _no_kernel_env(monkeypatch, tmp_path)
    root = Path(build.__file__).resolve().parents[2]
    assert build.in_checkout()
    assert build.kernel_dir() == root / "build" / "torch_kernels"
    assert build.library_path().parent == build.BUILD_DIR
    monkeypatch.setenv(build.KERNEL_DIR_ENV, str(tmp_path / "k"))
    assert build.kernel_dir() == tmp_path / "k"


@pytest.mark.parametrize("configured", [True, False])
def test_no_library_and_no_nvcc_raises_naming_the_directory(
        tmp_path, installed, monkeypatch, configured):
    """No fallback: with the library missing and no ``nvcc`` reachable, a
    load raises and names the directory it looked in."""
    _no_kernel_env(monkeypatch, tmp_path)
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("CUDA_HOME", str(empty))
    if configured:
        monkeypatch.setenv(build.KERNEL_DIR_ENV, str(tmp_path / "kernels"))
    mod = _copied_build(installed)
    with pytest.raises(RuntimeError) as e:
        mod.load_library()
    assert f"is not in {mod.kernel_dir()} " in str(e.value)
    assert "nvcc not found" in str(e.value)
    assert not mod.kernel_dir().exists()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for n, off in [(1 << 26, 0), (1_000_003, 0), (1_000_003, 1), (5, 3)]:
        x = torch.randn(n + off, device=dev, generator=gen)[off:]
        y = x.clone()
        for _ in range(3):
            stream_increment_(x)
            stream_increment_plain_(y)
        assert torch.equal(x, y)
        for dtype in (torch.float32, torch.bfloat16):
            t = x.to(dtype)
            torch.testing.assert_close(
                verify_stats(t, 0.5), verify_stats_plain(t, 0.5),
                rtol=0, atol=0, equal_nan=True,
            )
    c = torch.full((4096, 4096), 0.5, dtype=torch.bfloat16, device=dev)
    c[5, 7] = float("nan")
    assert torch.isnan(verify_stats(c, 0.5)).all()


@pytest.mark.cuda
def test_stream_increment_verify_matches_plain_on_the_card():
    """K1 and its verifying pass against their plain versions, exactly,
    at 1 GiB, at an odd length aligned and not, and at 5 elements past a
    12-byte offset; a NaN at the first or last element makes all three
    stats NaN; each verifying pass counts as one K1 launch and no K2
    launch, and the battery body launches K2 once (on C)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from k8s_operator_libs_tpu_torch.health import fused

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for n, off in [(1 << 28, 0), (1_000_003, 0), (1_000_003, 1), (5, 3)]:
        x = torch.randn(n + off, device=dev, generator=gen)[off:]
        y = x.clone()
        k1, k1v, k2 = (stream_increment_.launches,
                       stream_increment_verify_.launches,
                       verify_stats.launches)
        stream_increment_(x)
        stream_increment_plain_(y)
        for center in (0.0, 0.5):
            got = stream_increment_verify_(x, center)
            want = stream_increment_verify_plain_(y, center)
            torch.cuda.synchronize()
            assert torch.equal(x, y)
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)
        for where in (0, n - 1):
            x[where] = y[where] = float("nan")
            got = stream_increment_verify_(x, 0.5)
            want = stream_increment_verify_plain_(y, 0.5)
            torch.cuda.synchronize()
            assert torch.isnan(got).all() and torch.isnan(want).all()
            assert torch.equal(x.isnan(), y.isnan())
            x[where] = y[where] = 0.0
        assert stream_increment_.launches == k1 + 5
        assert stream_increment_verify_.launches == k1v + 4
        assert verify_stats.launches == k2
        del x, y
    a = torch.full((256, 256), 0.5, dtype=torch.bfloat16, device=dev)
    b = torch.full((256, 256), 1.0 / 256, dtype=torch.bfloat16, device=dev)
    x = torch.zeros(1 << 18, device=dev)
    k1, k1v, k2 = (stream_increment_.launches,
                   stream_increment_verify_.launches, verify_stats.launches)
    row = fused._battery_body(a, b, x)
    assert row.tolist() == [0.5, 0.5, 0.0, 8.0, 8.0, 8.0]
    assert stream_increment_.launches == k1 + fused.HBM_CHAIN_ITERS
    assert stream_increment_verify_.launches == k1v + 1
    assert verify_stats.launches == k2 + 1


@pytest.mark.cuda
def test_block_attention_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    before = block_attention.launches
    for (b, sq, sk, h, d), qo, ko, causal in K3_CARD_CASES:
        q = torch.randn((b, sq, h, d), device=dev, generator=gen)
        k = torch.randn((b, sk, h, d), device=dev, generator=gen)
        v = torch.randn((b, sk, h, d), device=dev, generator=gen)
        num, m, l = block_attention(q, k, v, qo, ko, causal)
        pnum, pm, pl = block_attention_plain(q, k, v, qo, ko, causal)
        torch.cuda.synchronize()
        assert float((m - pm).abs().max()) <= 1e-4
        assert float(((l - pl).abs() / pl.clamp_min(1.0)).max()) <= 1e-4
        assert float((num - pnum).abs().max()) <= 5e-2
    assert block_attention.launches == before + len(K3_CARD_CASES)
    with pytest.raises(ValueError):
        block_attention(q[..., :4].contiguous(), k[..., :4].contiguous(),
                        v[..., :4].contiguous())


@pytest.mark.cuda
def test_block_attention_merge_matches_plain_version_on_the_card():
    """The fused ring step at the shapes of the block test above, against
    its plain version within K3's limits, from the ring's first-step
    accumulator and from a random running one; its merge bit for bit
    against ``merge_plain`` on the kernel's own block outputs; and a
    ring over ``[cuda:0] * 4`` in one launch a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from k8s_operator_libs_tpu_torch.workloads.ring_attention import (
        make_ring_attention,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    before = block_attention.launches
    for (b, sq, sk, h, d), qo, ko, causal in K3_CARD_CASES:
        q = torch.randn((b, sq, h, d), device=dev, generator=gen)
        k = torch.randn((b, sk, h, d), device=dev, generator=gen)
        v = torch.randn((b, sk, h, d), device=dev, generator=gen)
        running = (
            torch.randn((b, sq, h, d), device=dev, generator=gen),
            torch.randn((b, sq, h), device=dev, generator=gen) + 1.0,
            torch.rand((b, sq, h), device=dev, generator=gen) * 20 + 0.5,
        )
        first = (torch.zeros((b, sq, h, d), device=dev),
                 torch.full((b, sq, h), -1e30, device=dev),
                 torch.zeros((b, sq, h), device=dev))
        block = block_attention(q, k, v, qo, ko, causal)
        for acc in (first, running):
            got = block_attention_merge_(*(t.clone() for t in acc), q, k, v,
                                         qo, ko, causal)
            plain = block_attention_merge_plain(*(t.clone() for t in acc),
                                                q, k, v, qo, ko, causal)
            own = merge_plain(*acc, *block)
            torch.cuda.synchronize()
            for g, o in zip(got, own):
                assert torch.equal(g, o)
            num, m, l = got
            pnum, pm, pl = plain
            assert float((m - pm).abs().max()) <= 1e-4
            assert float(((l - pl).abs() / pl.clamp_min(1.0)).max()) <= 1e-4
            assert float((num - pnum).abs().max()) <= 5e-2
    assert block_attention.launches == before + 3 * len(K3_CARD_CASES)
    fn, shard = make_ring_attention([dev] * 4)
    q, k, v = (torch.randn((1, 4 * 64, 2, 32), device=dev, generator=gen)
               for _ in range(3))
    before = block_attention.launches
    fn(shard(q), shard(k), shard(v))
    assert block_attention.launches == before + 4 * 4


@pytest.mark.cuda
def test_peer_reduce_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def same(got, want):
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        keep = ~got.isnan()
        assert torch.equal(got[keep].view(torch.int32),
                           want[keep].view(torch.int32))

    before = peer_reduce.launches
    launches = 0
    # (len, source offset, dst offset): aligned, unaligned alike,
    # unaligned apart, tiny.
    for k in (1, 2, 3, 5, 8):
        for n, off, doff in ((1 << 20, 0, 0), (1_000_003, 3, 3),
                             (1_000_003, 1, 0), (7, 2, 1)):
            srcs = [torch.randn(n + off, device=dev, generator=gen)
                    for _ in range(k)]
            srcs[k - 1][off + n // 2] = float("nan")
            dst = torch.empty(n + doff, device=dev)[doff:]
            want = torch.empty(n, device=dev)
            peer_reduce(dst, srcs, off, 3.0)
            peer_reduce_plain(want, srcs, off, 3.0)
            launches += 1
            same(dst, want)
            assert dst[n // 2].isnan()
    assert peer_reduce.launches == before + launches
    with pytest.raises(ValueError):
        peer_reduce(dst, srcs * 2)
    for n in (2, 3, 8):
        shards = [torch.randn(1001, device=dev, generator=gen)
                  for _ in range(n)]
        want = torch.empty(1001, device=dev)
        peer_reduce_plain(want, shards, 0, float(n))
        for out in all_reduce(shards, float(n)):
            same(out, want)
        ring = ring_shift(shards)
        for j in range(n):
            same(ring[j], shards[j - 1])


@pytest.mark.cuda
def test_ring_shift_matches_plain_version_on_the_card(monkeypatch):
    """``ring_shift`` on the card is one plan launch a call (one library
    call, n K4 nodes) and equals its plain version bit for bit: one
    element a member (the main path's), 2^20 and a 2-D shape; more than
    ``MAX_SOURCES`` members are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    calls = []
    real = collectives._RoundPlan.launch

    def launch(self, packed, divisor):
        calls.append(self)
        return real(self, packed, divisor)

    monkeypatch.setattr(collectives._RoundPlan, "launch", launch)
    for n in (2, 3, 4, 8):
        for shape in ((1,), (1 << 20,), (3, 67)):
            shards = [torch.randn(shape, device=dev, generator=gen)
                      for _ in range(n)]
            cpu = [s.cpu() for s in shards]
            before, calls[:] = peer_reduce.launches, []
            got = ring_shift(shards)
            assert len(calls) == 1 and peer_reduce.launches == before + n
            want = ring_shift(cpu)  # the plain version, on the CPU
            torch.cuda.synchronize()
            for j in range(n):
                assert got[j].shape == shape and got[j].device == dev
                assert torch.equal(got[j].cpu().view(torch.int32),
                                   want[j].view(torch.int32))
    with pytest.raises(ValueError, match="at most 8 members"):
        ring_shift([torch.zeros(1, device=dev)] * 9)


@pytest.mark.cuda
def test_peer_gather_and_rounds_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    before = peer_gather.launches
    for k in (1, 2, 3, 8):
        for n, skew in ((1 << 18, 0), (1001, 1), (5, 3)):
            pieces = [torch.randn(n + skew, device=dev, generator=gen)[skew:]
                      for _ in range(k)]
            offsets = [i * (n + 2) + 1 for i in range(k)]
            dst = torch.randn(k * (n + 2) + 4, device=dev, generator=gen)
            want = dst.clone()
            peer_gather(dst, pieces, offsets)
            peer_gather_plain(want, pieces, offsets)
            torch.cuda.synchronize()
            assert torch.equal(dst.view(torch.int32), want.view(torch.int32))
    # Rows landing a pitch apart (an all-gather along an inner
    # dimension): 16-byte rows, and ragged ones that take the byte path.
    for k, rows, width, skew in ((4, 64, 256, 0), (3, 17, 33, 1),
                                 (2, 5, 8, 2)):
        pitch = k * width + 3
        pieces = [torch.randn(rows * width + skew, device=dev,
                              generator=gen)[skew:] for _ in range(k)]
        offsets = [i * width + 1 for i in range(k)]
        dst = torch.randn(rows * pitch, device=dev, generator=gen)
        want = dst.clone()
        peer_gather(dst, pieces, offsets, rows, pitch)
        peer_gather_plain(want, pieces, offsets, rows, pitch)
        torch.cuda.synchronize()
        assert torch.equal(dst.view(torch.int32), want.view(torch.int32))
    assert peer_gather.launches == before + 15
    half = torch.randn(3, 5, device=dev, generator=gen).to(torch.bfloat16)
    for n in (2, 3, 4, 8):
        shards = [torch.randn(7, 33, device=dev, generator=gen)
                  for _ in range(n)]
        for dim in (0, 1):
            for out in all_gather(shards, dim):
                assert torch.equal(out, torch.cat(shards, dim))
        for out in all_gather([half] * n, -1):
            assert torch.equal(out, torch.cat([half] * n, -1))
        wide = [torch.randn(2, 16, 64, device=dev, generator=gen)
                for _ in range(n)]
        for out in all_gather(wide, -1):
            assert torch.equal(out, torch.cat(wide, -1))
        want = torch.empty(7 * 33, device=dev)
        peer_reduce_plain(want, [s.view(-1) for s in shards], 0, float(n))
        for _ in range(6):  # new pointers each round: the graph repointed
            fresh = [s.clone() for s in shards]
            outs = all_reduce(fresh, float(n))
            for out in outs:
                assert out.shape == (7, 33)
                assert torch.equal(out.view(-1).view(torch.int32),
                                   want.view(torch.int32))
    # Chained rounds: each round's outputs are the next one's inputs.
    s = [torch.full((1001,), float(i + 1), device=dev) for i in range(8)]
    for _ in range(4):
        s = all_reduce(s, divisor=8.0)
    torch.cuda.synchronize()
    assert all(bool((t == 4.5).all()) for t in s)
    # Persistent rounds, into new outputs and in place (the mean of
    # equal values is those values, so every round leaves 4.5).
    s = [torch.full((1001,), float(i + 1), device=dev) for i in range(8)]
    outs = all_reduce_init(s)()
    torch.cuda.synchronize()
    assert all(bool((t == 36.0).all()) for t in outs)
    start = all_reduce_init(s, divisor=8.0, out=s)
    for _ in range(3):
        assert start() is start()
    torch.cuda.synchronize()
    assert all(bool((t == 4.5).all()) for t in s)


@pytest.mark.cuda
def test_peer_gather_split_grid_matches_plain_on_the_card():
    """K5 byte for byte over 2, 3, 4, 5 and 8 pieces (aligned, ragged,
    unaligned alike with dst and apart), rows a pitch apart at the
    sharded canary's gathers, rows whose length is not a multiple of 16
    bytes, rows that share an offset past a 16-byte boundary (byte head
    and tail on every row), and bf16; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def gather(dtype, k, rows, width, skew, offsets, pitch, size):
        pieces = [torch.randn(rows * width + skew, device=dev,
                              generator=gen).to(dtype)[skew:]
                  for _ in range(k)]
        dst = torch.randn(size, device=dev, generator=gen).to(dtype)
        want = dst.clone()
        peer_gather(dst, pieces, offsets, rows, pitch)
        peer_gather_plain(want, pieces, offsets, rows, pitch)
        torch.cuda.synchronize()
        assert torch.equal(dst.view(torch.uint8), want.view(torch.uint8))

    before = peer_gather.launches
    cases = 0
    for k in (2, 3, 4, 5, 8):
        for total, skew, gap in ((1 << 20, 0, 0), (1_000_003, 1, 1),
                                 (1_000_003, 3, 2), (37, 2, 1)):
            n = total // (k + 1)
            skip = k // 2  # the launching member's own range, kept
            offsets = [(i + (i >= skip)) * (n + gap) + gap for i in range(k)]
            gather(torch.float32, k, 1, n, skew, offsets, 0,
                   (k + 1) * (n + gap) + gap)
            cases += 1
    # (dtype, k, rows, width, skew, gap): the canary's gathers along -1
    # (tp 4 and 2), 67 fp32 (268 bytes) and 5 fp32 (20 bytes) rows, 64
    # fp32 rows 4 bytes past a boundary with a pitch of 16-byte multiples,
    # and bf16 rows of 6 bytes.
    for dtype, k, rows, width, skew, gap in (
        (torch.float32, 4, 16 * 512, 256, 0, 0),
        (torch.float32, 2, 16 * 512, 512, 0, 0),
        (torch.float32, 3, 1001, 67, 1, 1),
        (torch.float32, 5, 77, 5, 0, 0),
        (torch.float32, 3, 129, 64, 1, 4),
        (torch.bfloat16, 8, 7, 3, 1, 2),
    ):
        pitch = k * width + gap
        offsets = [i * width + (skew if gap == 4 else gap) for i in range(k)]
        gather(dtype, k, rows, width, skew, offsets, pitch, rows * pitch)
        cases += 1
    assert peer_gather.launches == before + cases


@pytest.mark.cuda
def test_collectives_across_cards():
    """The host's collectives over real peers: K4 reading other cards'
    buffers through peer access, the all-reduce (chained rounds too) and
    ring across every card (and a list that repeats cards), both ICI
    probes and the battery, fused and not."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from k8s_operator_libs_tpu_torch.health import probes

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    gen = torch.Generator()
    gen.manual_seed(0)

    def same(got, want):
        torch.cuda.synchronize()
        got, want = got.cpu(), want.cpu()
        assert torch.equal(got.isnan(), want.isnan())
        keep = ~got.isnan()
        assert torch.equal(got[keep].view(torch.int32),
                           want[keep].view(torch.int32))

    prev = torch.cuda.current_device()
    srcs = [torch.randn(1_000_003, generator=gen).to(d) for d in cards]
    for dst_card in (cards[0], cards[-1]):
        dst = torch.empty(1_000_000, device=dst_card)
        want = torch.empty(1_000_000, device=dst_card)
        peer_reduce(dst, srcs[:8], off=3, divisor=3.0)
        peer_reduce_plain(want, srcs[:8], off=3, divisor=3.0)
        same(dst, want)
    assert torch.cuda.current_device() == prev
    repeated = cards[:-1] + cards[:1]
    for members in (cards, repeated, [cards[1], cards[0]] * 2):
        n = len(members)
        for elems in (1 << 20, 1001):
            host = torch.randn(n, elems, generator=gen)
            shards = [host[i].to(d) for i, d in enumerate(members)]
            want = torch.empty(elems)
            peer_reduce_plain(want, list(host), 0, float(n))
            outs = all_reduce(shards, float(n))
            for out, d in zip(outs, members):
                assert out.device == d
                same(out, want)
            # Chained rounds, each on the last one's outputs: past the
            # plan's graphs, each round repoints a graph's nodes on every
            # card.
            for _ in range(3):
                want = torch.empty(elems)
                peer_reduce_plain(want, [o.cpu() for o in outs], 0, float(n))
                outs = all_reduce(outs, float(n))
                for out in outs:
                    same(out, want)
            ring = ring_shift(shards)
            for j in range(n):
                same(ring[j], host[j - 1])
            gathered = all_gather(shards, 0)
            for out, d in zip(gathered, members):
                assert out.device == d
                same(out, host.reshape(-1))
    assert torch.cuda.current_device() == prev
    ar = probes.ici_allreduce_probe(cards)
    assert ar.ok, ar.detail
    rp = probes.ici_ring_probe(cards)
    assert rp.ok, rp.detail
    for fused in (True, False):
        checks = probes.run_host_probe(cards, matmul_n=1024, hbm_mib=64,
                                       fused=fused, max_iters=64)
        assert all(c.ok for c in checks), [c.detail for c in checks]
        assert checks[1].metrics["fused"] == float(fused)
