"""The port's build directory (``utils/compile_cache.py``): the
resolution order of the JAX package's compile cache (the
``--compile-cache`` flag, ``TPUMNIST_COMPILE_CACHE``, a harness's pinned
directory, the default), the CUDA kernels' and the native library's build
paths following it, the record of builds and graph captures
(``compile_log``), the precompile thread, and cold and warm CLI runs that
build the native library once and then reuse it. This machine has no
``nvcc``: the kernel side checks paths and the precompile's plan only.
Twin of the resolution cases of ``tests/test_compile_cache.py``."""

import json
import os
import subprocess
import sys

import pytest

from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.data import native
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.utils import compile_cache
from pytorch_distributed_mnist_tpu_torch.utils.profiling import (
    CompileLog,
    compile_log,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120  # seconds any one CLI process may take


@pytest.fixture
def cache_state(monkeypatch):
    """Module state restored around each test (the pin, the build
    root)."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setattr(compile_cache, "_ambient", None)
    monkeypatch.setattr(compile_cache, "_pinned", False)
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", cuda_build.BUILD_ROOT)
    yield


def test_default_is_the_checkouts_build_directory(cache_state):
    want = os.path.join(REPO, "build", "torch_kernels")
    assert compile_cache.default_cache_dir() == want
    assert compile_cache.resolve_cache_dir() == want
    assert compile_cache.configure() == want == cuda_build.BUILD_ROOT


def test_flag_beats_env_and_default(cache_state, monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    assert compile_cache.resolve_cache_dir(str(tmp_path / "flag")) == \
        str(tmp_path / "flag")
    assert compile_cache.configure(str(tmp_path / "flag")) == \
        str(tmp_path / "flag")


def test_env_beats_pinned_and_default(cache_state, monkeypatch, tmp_path):
    compile_cache.configure_ambient(str(tmp_path / "pinned"))
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    assert compile_cache.configure() == str(tmp_path / "env")


def test_pinned_ambient_followed_by_flagless(cache_state, tmp_path):
    assert compile_cache.configure_ambient(str(tmp_path / "h")) == \
        str(tmp_path / "h")
    assert compile_cache.configure() == str(tmp_path / "h")
    assert compile_cache.configure(str(tmp_path / "x")) == \
        str(tmp_path / "x")  # a flag still wins
    assert compile_cache.configure() == str(tmp_path / "h")


@pytest.mark.parametrize("via", ["flag", "env"])
def test_empty_string_is_a_fresh_temporary_directory(cache_state,
                                                     monkeypatch, via):
    if via == "env":
        monkeypatch.setenv(compile_cache.ENV_VAR, "")
        first, second = compile_cache.configure(), compile_cache.configure()
    else:
        first = compile_cache.configure("")
        second = compile_cache.configure("")
    assert first != second
    for path in (first, second):
        assert os.path.isdir(path) and os.listdir(path) == []
        assert os.path.basename(path).startswith("tpumnist-build-")


def test_empty_string_directory_is_removed_at_exit(tmp_path):
    code = ("from pytorch_distributed_mnist_tpu_torch.utils import "
            "compile_cache\nprint(compile_cache.configure(''))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip()
    assert path and not os.path.exists(path)


def test_kernel_and_native_builds_follow_the_directory(cache_state,
                                                      tmp_path):
    root = compile_cache.configure(str(tmp_path / "cache"))
    for name in cuda_build.KERNELS:
        path = cuda_build.library_path(name)
        assert path.startswith(root + os.sep)
        assert os.path.basename(os.path.dirname(path)).startswith(name + "-")
    assert native.library_path().startswith(root + os.sep)
    assert cuda_build.BUILD_ROOT == root


def test_the_native_library_builds_into_the_configured_directory(
        cache_state, tmp_path):
    compile_cache.configure(str(tmp_path / "cache"))
    compile_log.reset()
    path = native.build()
    assert path.startswith(str(tmp_path / "cache")) and os.path.isfile(path)
    native.build()
    assert compile_log.stats()["builds"]["native"]["built"] == 1
    assert compile_log.stats()["builds"]["native"]["reused"] == 1


def test_compile_log_counts_builds_and_captures():
    log = CompileLog()
    log.record_build("xent", 6.5, built=True)
    log.record_build("xent", 0.0, built=False)
    log.record_build("adam", 0.0, built=False)
    log.record_capture("train_step", 0.25)
    log.record_capture("eval_step", 0.5)
    log.record_capture("train_step", 0.25)
    stats = log.stats()
    assert stats["built"] == 1 and stats["reused"] == 2
    assert stats["graph_captures"] == 3
    assert stats["builds"]["xent"] == {"built": 1, "reused": 1,
                                       "seconds": 6.5}
    assert stats["captures"]["train_step"] == {"captures": 2,
                                               "seconds": 0.5}
    log.reset()
    assert log.stats()["built"] == 0


def test_cuda_build_records_reuse_without_nvcc(cache_state, tmp_path,
                                               monkeypatch):
    compile_cache.configure(str(tmp_path))
    target = cuda_build.library_path("xent")
    os.makedirs(os.path.dirname(target))
    open(target, "wb").close()  # an earlier build's library
    compile_log.reset()
    cuda_build.build(["xent"])
    assert compile_log.stats()["builds"]["xent"] == {
        "built": 0, "reused": 1, "seconds": 0.0}


def test_precompile_builds_on_a_thread_and_raises_at_join(monkeypatch):
    import threading

    seen = {}

    def fake_build(names):
        seen["names"] = list(names)
        seen["thread"] = threading.current_thread().name
        raise RuntimeError("kernel build failed: nvcc exit 1")

    monkeypatch.setattr(cuda_build, "build", fake_build)
    job = cuda_build.Precompile(["xent", "adam"])
    with pytest.raises(RuntimeError, match="kernel build failed"):
        job.join()
    assert seen == {"names": ["xent", "adam"],
                    "thread": "kernel-precompile"}


@pytest.mark.parametrize("flags, want", [
    ([], []),
    (["--loss", "fused", "--optimizer", "adam_pallas"], ["xent", "adam"]),
    (["--model", "vit", "--attention", "flash"], ["flash_fwd", "flash_bwd"]),
    (["--model", "vit", "--attention", "flash", "--patch-size", "2"],
     ["flash_fwd", "flash_bwd_tiled"]),
    (["--model", "vit", "--attention", "flash", "--dtype", "f32",
      "--loss", "fused"], ["xent", "flash_tf32"]),
])
def test_precompile_plans_the_libraries_the_run_launches(flags, want):
    args = cli.build_parser().parse_args(flags)
    assert cli._run_kernels(args) == want


def test_precompile_runs_only_on_the_card(monkeypatch, tmp_path):
    started = []
    monkeypatch.setattr(cuda_build, "Precompile",
                        lambda names: started.append(names))
    cli.run(cli.build_parser().parse_args([
        "--device", "cpu", "--model", "linear", "--dataset", "synthetic",
        "--synthetic-train-size", "128", "--synthetic-test-size", "64",
        "--batch-size", "64", "--epochs", "1", "--loss", "fused",
        "--checkpoint-dir", str(tmp_path)]))
    assert started == []


def _cli_run(cache: str, ckpt: str, *extra) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "from pytorch_distributed_mnist_tpu_torch import cli\n"
         "s = cli.run(cli.build_parser().parse_args(sys.argv[1:]))\n"
         "print('SUMMARY ' + json.dumps(s['compile_stats']))\n",
         "--device", "cpu", "--model", "linear", "--dataset", "synthetic",
         "--synthetic-train-size", "128", "--synthetic-test-size", "64",
         "--batch-size", "64", "--epochs", "1", "--compile-cache", cache,
         "--checkpoint-dir", ckpt, *extra],
        capture_output=True, text=True, cwd=REPO, timeout=WORLD_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("SUMMARY ")][-1]
    return {"stats": json.loads(line[8:]), "out": proc.stdout}


def test_a_cold_run_builds_once_and_a_warm_run_builds_nothing(tmp_path):
    cache = str(tmp_path / "cache")
    cold = _cli_run(cache, str(tmp_path / "a"))
    assert cold["stats"]["builds"]["native"]["built"] == 1
    assert f"build directory: {cache}" in cold["out"]
    assert "build[native]: 1 built" in cold["out"]
    warm = _cli_run(cache, str(tmp_path / "b"), "--no-precompile")
    assert warm["stats"]["built"] == 0
    assert warm["stats"]["builds"]["native"]["reused"] == 1
    (entry,) = os.listdir(cache)  # the one library of the CPU run
    assert entry.startswith("native-")
