"""K3: the least time its calls' work over each env's active contacts needs
at the card's peaks, over K3's device time in the traced steps, in
percent."""


def read(r):
    return r.roofline("k3")
