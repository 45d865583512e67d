"""idle_share.churn: the share of the traced window in which the card ran
nothing, %, in the placement churn cells.  The same reading as every `idle_share.*`
metric; each name moves the end-to-end metric its cells report
(`pg_mappings_per_s`)."""


def read(r):
    return r.idle_share()
