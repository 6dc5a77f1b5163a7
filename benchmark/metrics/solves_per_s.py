"""solves_per_s: lanes (or driver solves) delivered per second: all
units' solves over the window, from its start to the end of its last unit
(host clock)."""


def read(record):
    return sum(u["work"]["solves"] for u in record["units"]) \
        / record["window_s"]
