"""Share of the search window in which the device idles while the program
is in `cocodr.search` outside its `cocodr.search.to_host` spans, %: the
program's part of idle_share.search (the plan's free-memory read, the
issue of each chunk); the rest is the caller's, between searches, and the
copies'."""
from portbench import spans


def read(run):
    return spans.idle_share(run, "cocodr.search", "cocodr.search.to_host")
