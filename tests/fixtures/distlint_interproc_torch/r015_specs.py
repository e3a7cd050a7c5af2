"""R015 in the port's spec form: rule tables, spec_to_placements specs
and the spec builders' axis arguments, checked against the axes the
project's meshes declare (here ("dp", "tp") and ("fsdp",))."""

from pytorch_distributed_example_tpu_torch.dtensor import spec_to_placements
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh, init_device_mesh
from pytorch_distributed_example_tpu_torch.parallel.sharding import (
    data_spec,
    fsdp_rules,
    shard_params,
    spec_for,
)


def build_mesh(devices):
    return DeviceMesh(devices, (2, 2), ("dp", "tp"))


def gang_mesh(world):
    return init_device_mesh(("fsdp",), (world,))


def good_rules(tp_axis="tp"):
    return [
        (r"w$", (tp_axis, None)),
        (r"b$", ("tp",)),
        (r"e$", (("dp", "tp"), None)),
        (r".*", ()),
    ]


def bad_rules():
    return [
        (r"w$", ("model", None)),  # expect: R015
        (r".*", ()),
    ]


def appended_rules(rules):
    rules.append((r"q$", ("tp", "heads")))  # expect: R015
    rules += [(r"k$", ("dp",))]
    return rules


def place(mesh):
    good = spec_to_placements(("dp", None), mesh)
    bad = spec_to_placements((None, "sequence"), mesh)  # expect: R015
    return good, bad


def builders(mesh, params, x):
    specs = [
        data_spec(mesh, ("dp",)),
        data_spec(mesh, batch_axes=("batch",)),  # expect: R015
        fsdp_rules("fsdp"),
        fsdp_rules(axis="zero"),  # expect: R015
    ]
    spec_for("w", tuple(x.shape), [(r".*", ("fsdp",))], mesh)
    shard_params(params, mesh, rules=[(r".*", ("expert",))])  # expect: R015
    return specs
