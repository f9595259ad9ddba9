"""Port of ``repro.launch``: the entry points users run
(``python -m repro_torch.launch.serve``), the tensor-parallel serving
mesh (``make_tp_mesh``, ``TPMesh``) and the (data, model) mesh of the
sharded steps (``make_mesh``, ``Mesh``; ``launch.steps``)."""
from repro_torch.launch.mesh import (
    Mesh, NamedSharding, PartitionSpec, ShardedTensor, TPMesh, make_mesh,
    make_production_mesh, make_tp_mesh, small_test_mesh)

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "ShardedTensor", "TPMesh",
           "make_mesh", "make_production_mesh", "make_tp_mesh", "small_test_mesh"]
