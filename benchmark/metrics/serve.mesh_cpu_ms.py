"""serve + ops.isosurface (host meshing): the sum of serve_meshes'
per-shape `t_mesh_s` (the program's own host clock around the mesher)
over the meshes of the traced batch, per mesh."""


def read(ctx):
    st = ctx.driver.stats
    if not st:
        return None
    return 1e3 * sum(s["t_mesh_s"] for s in st) / len(st)
