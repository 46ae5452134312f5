"""frontend.overflowed_match_share: the program's
``FrontendFrontierOverflowMatches`` over ``FrontendMatches`` in percent:
the frontend's branch-and-bound matches whose frontier reached its cap
at some level, so that the search may have pruned the true optimum."""


def read(run):
    counters = run.counters.get("Counters", {})
    matches = counters.get("FrontendMatches")
    if matches is None or matches["value"] <= 0:
        return None
    over = counters.get("FrontendFrontierOverflowMatches", {"value": 0.0})
    return 100.0 * over["value"] / matches["value"]
