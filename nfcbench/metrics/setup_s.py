"""setup_s (s, host clock): process start to the opening of the window:
imports, the CUDA context, the kernel library (built on a checkout's
first run), the traffic, the entry's construction and its warm-up."""


def read(w):
    return w.setup_s
