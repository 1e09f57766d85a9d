"""idle_share.sync: the share (%) of the profiled sync in which no
kernel, copy or set ran on the device."""
from perfbench.lib.trace import idle_share


def read(rec):
    return idle_share(rec.get("trace"))
