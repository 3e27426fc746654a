"""`kernels/_build.build` on the CPU, with a stand-in for nvcc (the real
one runs only on the machine with the card): a library is built once
and reused, rebuilt when its source or a local header it includes is
edited, and two threads of one process that build the same source
at once both get the library."""
import subprocess
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """nvcc replaced by a slow copy of the source to the `-o` path; returns
    the list of outputs it wrote."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    outs = []

    def run(cmd, capture_output, text):
        out = Path(cmd[cmd.index("-o") + 1])
        time.sleep(0.2)             # both build threads inside the compile
        out.write_bytes(Path(cmd[-1]).read_bytes())
        outs.append(out)
        return subprocess.CompletedProcess(cmd, 0, "ptxas info\n", "")
    monkeypatch.setattr(_build.subprocess, "run", run)
    return outs


def test_concurrent_builds_of_one_source_both_succeed(tmp_path, fake_nvcc):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    results, errors = [], []

    def one():
        try:
            results.append(_build.build("k", src=src))
        except Exception as e:      # noqa: BLE001 (reported below)
            errors.append(e)
    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(results) == 2 and results[0] == results[1]
    assert results[0].read_text() == "// a kernel\n"
    assert len({str(p) for p in fake_nvcc}) == 2    # one temporary each
    assert not list(results[0].parent.glob("*.tmp.so"))


def test_a_built_library_is_reused(tmp_path, fake_nvcc):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    first = _build.build("k", src=src)
    assert _build.build("k", src=src) == first and len(fake_nvcc) == 1
    src.write_text("// edited\n")
    assert _build.build("k", src=src) != first and len(fake_nvcc) == 2


def test_an_edited_local_header_is_rebuilt(tmp_path, fake_nvcc):
    src = tmp_path / "k.cu"
    src.write_text('// a kernel\n#include "forms.cuh"\n')
    header = tmp_path / "forms.cuh"
    header.write_text("// the short forms\n")
    first = _build.build("k", src=src)
    assert _build.build("k", src=src) == first and len(fake_nvcc) == 1
    header.write_text("// the short forms, edited\n")
    assert _build.build("k", src=src) != first and len(fake_nvcc) == 2
