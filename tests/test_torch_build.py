"""The kernel build's lock across processes (``mirbft_tpu_torch.ops._build``).

Several processes can reach a kernel's first use at once: the cohost
deployment starts one host process per node index, each with its own plane
on the card.  Two processes build the same source into one build directory
at once here, with a stand-in for ``nvcc`` (this machine has none) that
sleeps, counts its runs and writes the library; the directory's lock must
let one compile it and the other find it built.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    args = sys.argv[1:]
    with open({runs!r}, "a") as fh:
        fh.write("run\\n")
    time.sleep(1.0)
    with open(args[args.index("-o") + 1], "w") as fh:
        fh.write("library")
    print("ptxas info    : stand-in")
""")

_BUILDER = textwrap.dedent("""\
    import sys
    from mirbft_tpu_torch.ops import _build
    _build.BUILD_DIR = sys.argv[1]
    _build.CSRC = sys.argv[2]
    print(_build.ensure_built("toy"))
""")


def test_two_processes_build_a_source_once(tmp_path):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    runs = tmp_path / "runs.txt"
    nvcc = cuda / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, runs=str(runs)))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "toy.cu").write_text("extern \"C\" int toy() { return 1; }\n")
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_HOME=str(tmp_path / "cuda"))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILDER, str(build), str(csrc)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = [proc.communicate(timeout=60) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert os.path.dirname(path) == str(build)
    with open(path) as fh:
        assert fh.read() == "library"
    assert runs.read_text() == "run\n"  # compiled once, by one process
    # A later first use finds the library and compiles nothing.
    later = subprocess.run(
        [sys.executable, "-c", _BUILDER, str(build), str(csrc)],
        env=env, capture_output=True, text=True, timeout=60,
    )
    assert later.returncode == 0 and later.stdout.strip() == path
    assert runs.read_text() == "run\n"
