"""fetch_skipped_pct.steady: share of the microloop's passes whose plan fetch the
on-device fingerprint skipped: the solver's ``micro_skipped_syncs`` over those
and its ``micro_fetches``, over the window."""


def read(ctx):
    skipped = sum(r["skipped"] for r in ctx.records if "skipped" in r)
    total = skipped + sum(r["fetched"] for r in ctx.records if "fetched" in r)
    return 100.0 * skipped / total if total else None
