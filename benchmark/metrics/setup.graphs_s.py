"""setup.graphs_s: seconds of the program's `engine.load.graphs` span (the
eager warm forwards of each bucket, where the kernel library loads, and
the capture of its CUDA graph), less the `ops.build` spans inside it (nvcc
compiling the kernels, the first run of a checkout only)
(`harness/program_spans.py`)."""

from benchmark.harness.program_spans import last, recorder


def read(rec):
    graphs = last("engine.load.graphs")
    if graphs is None:
        return None
    built = sum(r.end_ns - r.start_ns for r in recorder()("ops.build")[0]
                if graphs.start_ns <= r.start_ns and r.end_ns <= graphs.end_ns)
    return (graphs.end_ns - graphs.start_ns - built) / 1e9
