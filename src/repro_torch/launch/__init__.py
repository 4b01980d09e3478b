from repro_torch.launch.mesh import make_mesh, make_production_mesh

__all__ = ["make_mesh", "make_production_mesh"]
