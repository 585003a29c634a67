"""infer_pairs_per_s: every pair answered in the window over the window's
whole length (host clock, the window ends with a fetch)."""


def read(rec):
    return rec.counts["pairs"] / rec.window_s
