"""An axis-scoped rank collective, as `nn/functional.py` writes them: it
runs over a mesh axis name and takes no process group."""


def all_reduce(x, op=None, axis_name="dp", axes=None):
    return x


def all_gather(x, axis_name="dp", axis=0, tiled=True, axes=None):
    return x
