"""idle_share.io: the share of the traced window in which the card ran
nothing, %, in the erasure-coded I/O cells.  The same reading as every `idle_share.*`
metric; each name moves the end-to-end metric its cells report
(`ec_gbps`)."""


def read(r):
    return r.idle_share()
