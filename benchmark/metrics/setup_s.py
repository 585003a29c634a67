"""setup_s: seconds from process start to the first measured call or
request (weights drawn, deployment written and loaded, kernels built,
graphs captured, warm-up). Host clock."""


def read(rec):
    return rec.setup_s
