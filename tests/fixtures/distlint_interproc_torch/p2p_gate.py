"""Rank-gated point-to-point calls are the sender/receiver idiom, even
though a driver-mode send dispatches half of a permute pair; a
rank-gated call to a collective helper still desynchronizes."""


def send(tensor, dst, group=None, src=None):
    out, work = group._dispatch("permute", tensor, None)
    return out, work


def recv(tensor, src, group=None):
    out, work = group._dispatch("permute", tensor, None)
    return out, work


def exchange(x, buf, rank, group=None):
    if rank == 0:
        send(x, 1, group=group)
    else:
        recv(buf, 0, group=group)
    return buf


def flush(t, dist, group=None):
    dist.all_reduce(t, group=group)


def gated_flush(t, dist, rank, group=None):
    if rank == 0:
        flush(t, dist, group=group)  # expect: R001
