"""K1: the least time its calls' work needs at the card's peaks, over K1's
device time in the traced steps, in percent."""


def read(r):
    return r.roofline("k1")
