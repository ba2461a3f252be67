"""The port's extractors (code2vec_tpu_torch/extractor/,
serving/extractor.py) against the JAX package's, on the CPU.

- the Python frontend's lines equal the JAX frontend's, byte for byte,
  on a set of sources, and `java_string_hash` (Python and C) equals the
  JAX one;
- the native extractor, built at first use from the port's copy of the
  C++ sources with the host compiler, gives `tests/golden/*.expected`
  through its binary and in process through `libc2v.so` (skipped, with
  the reason, only where there is no C++ compiler);
- a failed build raises `ExtractorError` with the compiler's stderr;
  `C2V_EXTRACTOR` names the binary that runs;
- the `ExtractorPool` restarts in place after a `serve/extract` crash,
  sheds while it restarts, and goes dead when the rebuild cannot
  succeed.

Tolerances: none; extractor output is text and must be equal.
"""

import os
import stat

import pytest

from code2vec_tpu.extractor import python_extractor as jpy
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.extractor import python_extractor as tpy
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.batcher import ServerOverloaded
from code2vec_tpu_torch.serving.extractor import (Extractor, ExtractorCrash,
                                                  ExtractorError,
                                                  ExtractorPool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")

PY_SOURCES = [
    "def add_two(x):\n    return x + 2\n",
    ("def outer(a, b):\n    def inner(c):\n        return c * 2\n"
     "    return inner(a) + b\n\nclass K:\n"
     "    def method_one(self, value):\n        if value > 0:\n"
     "            return self.cache[value]\n        return None\n"),
    ("import os\n\ndef read_all_lines(path, strip=True):\n"
     "    with open(path) as f:\n        out = []\n        for ln in f:\n"
     "            out.append(ln.strip() if strip else ln)\n"
     "    return [x for x in out if x]\n\n"
     "async def fetchItems(session, *urls, **kw):\n"
     "    try:\n        return await session.get(urls[0], **kw)\n"
     "    except KeyError as e:\n        raise ValueError(str(e))\n"),
    "def broken(:\n  pass",
    "x = 1\n",
]


@pytest.mark.parametrize("source", PY_SOURCES)
@pytest.mark.parametrize("max_len,max_width", [(8, 2), (4, 1), (14, 3)])
def test_python_frontend_equals_jax(source, max_len, max_width):
    got = tpy.extract_source(source, max_len, max_width)
    assert got == jpy.extract_source(source, max_len, max_width)


WORDS = ["", "a", "hello", "METHOD_NAME", "Nm^Mth|Blk", "ünïcødé",
         "x" * 300, "(NameExpr)^(MethodCallExpr)_(NameExpr)"]


def test_java_string_hash_equals_jax():
    assert [tpy.java_string_hash(w) for w in WORDS] == \
        [jpy.java_string_hash(w) for w in WORDS]


@pytest.fixture(scope="module")
def native():
    """The port's native extractor, built from its sources (module
    scope: one build for the file)."""
    try:
        _build.cxx_path()
    except _build.KernelBuildError as e:
        pytest.skip(f"no host C++ compiler to build the native extractor "
                    f"({e})")
    from code2vec_tpu_torch.extractor import native as mod
    mod.binary_path()
    mod.library_path()
    return mod


def test_native_java_string_hash_equals_jax(native):
    assert [native.java_string_hash(w) for w in WORDS if w.isascii()] == \
        [jpy.java_string_hash(w) for w in WORDS if w.isascii()]


@pytest.mark.parametrize("name", ["Example.java", "Hard.java"])
@pytest.mark.parametrize("use_native", [True, False])
def test_native_extractor_equals_golden(native, name, use_native,
                                        monkeypatch):
    """`c2v_extract --file` (use_native=False) and libc2v in process
    give the checked-in expected lines."""
    monkeypatch.delenv("C2V_EXTRACTOR", raising=False)
    with open(os.path.join(GOLDEN, name + ".expected")) as f:
        want = f.read().splitlines()
    ex = Extractor(Config(), use_native=use_native)
    ex.preflight()
    names, lines = ex.extract_paths(os.path.join(GOLDEN, name))
    assert lines == want
    assert names == [ln.split(" ", 1)[0] for ln in want]


def test_failed_build_raises_with_the_compilers_stderr(tmp_path,
                                                       monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'fatal: no such toolchain' >&2\n"
                   "exit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("C2V_EXTRACTOR", raising=False)
    for use_native in (True, False):
        with pytest.raises(ExtractorError, match="no such toolchain"):
            Extractor(Config(), use_native=use_native).preflight()
    assert not os.listdir(tmp_path / "build" / "extractor")


def test_c2v_extractor_names_the_binary(tmp_path, monkeypatch):
    fake = tmp_path / "fake_extract"
    fake.write_text("#!/bin/sh\necho 'get|x int,1,x METHOD_NAME,2,x'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    src = tmp_path / "A.java"
    src.write_text("class A {}\n")
    monkeypatch.setenv("C2V_EXTRACTOR", str(fake))
    ex = Extractor(Config())
    assert not ex.use_native
    ex.preflight()
    assert ex.extract_paths(str(src)) == (["get|x"],
                                          ["get|x int,1,x METHOD_NAME,2,x"])
    monkeypatch.setenv("C2V_EXTRACTOR", str(tmp_path / "missing"))
    with pytest.raises(ExtractorError, match="not found"):
        Extractor(Config()).preflight()


@pytest.fixture
def py_source(tmp_path):
    p = tmp_path / "demo.py"
    p.write_text("def add_one(x):\n    y = x + 1\n    return y\n")
    return str(p)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def test_pool_restarts_in_place_after_a_serve_extract_crash(py_source):
    faults.install({"sites": {"serve/extract": {"action": "raise"}}},
                   log=lambda _m: None)
    pool = ExtractorPool(Config(SERVE_EXTRACT_WORKERS=2), language="python")
    with pytest.raises(ExtractorCrash, match="crashed"):
        pool.extract_paths(py_source)
    pool.restart_thread.join(timeout=30)
    assert not pool.restart_thread.is_alive() and not pool.restarting
    names, lines = pool.extract_paths(py_source)
    assert names == ["add|one"] and lines == tpy.extract_file(py_source)
    pool.close()


def test_pool_sheds_while_restarting_and_dies_when_rebuild_fails(
        py_source, monkeypatch):
    pool = ExtractorPool(Config(), language="python")
    pool._restarting = True
    with pytest.raises(ServerOverloaded, match="restarting"):
        pool.submit(py_source)
    pool._restarting = False

    def no_rebuild(self):
        raise ExtractorError("the binary is gone")
    monkeypatch.setattr(Extractor, "preflight", no_rebuild)
    faults.install({"sites": {"serve/extract": {"action": "raise"}}},
                   log=lambda _m: None)
    with pytest.raises(ExtractorCrash):
        pool.extract_paths(py_source)
    pool.restart_thread.join(timeout=30)
    with pytest.raises(ExtractorError, match="the binary is gone"):
        pool.submit(py_source)
    pool.close()


def test_per_input_failure_does_not_restart(tmp_path):
    bad = tmp_path / "empty.py"
    bad.write_text("x = 1\n")
    pool = ExtractorPool(Config(), language="python")
    with pytest.raises(ExtractorError, match="no methods"):
        pool.extract_paths(str(bad))
    assert pool.restart_thread is None and not pool.restarting
    pool.close()
