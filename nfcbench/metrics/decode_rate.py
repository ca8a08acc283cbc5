"""decode_rate (samples/s, host clock): every sample of every stream that
the walk finished between the drain events that open and close the
window, over the time between them."""


def read(w):
    return (w.drained_close - w.drained_open) / w.seconds
