"""Port of ``repro.launch``: the entry points users run
(``python -m repro_torch.launch.serve``) and the tensor-parallel mesh
(``make_tp_mesh``, ``TPMesh``)."""
from repro_torch.launch.mesh import TPMesh, make_tp_mesh

__all__ = ["TPMesh", "make_tp_mesh"]
