"""Scene kinds, one module each, found by a configuration's `kind`
(program.kind_of).  A kind's module has:

  geometry(config)        the inputs.Geometry its scene is made of
  Program(config, geometry, device)
                          a program.Program subclass: the scene on the
                          device (in set-up or, where it changes, each
                          step) and what the reference judges
  reference_scene(config, geometry, key, device, dtype, vox_dtype)
                          the reference's scene of vertex set `key` and,
                          for a voxel scene, its voxelize (occ, set_calls)
"""
