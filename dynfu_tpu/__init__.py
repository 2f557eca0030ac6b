"""dynfu_tpu — a DynamicFusion engine in JAX (XLA, GPU).

A from-scratch re-design of the capabilities of swarth100/dynfu (C++/CUDA/Opt)
as batched, jitted array programs:

* depth frontend (dists / bilateral / pyramid / point+normal maps)   -> ops.imgproc
* TSDF volume (integrate / raycast / extract)                        -> volume.tsdf
* marching cubes                                                     -> mesh.mc
* projective point-to-plane ICP                                      -> rigid.icp
* warp field (deformation nodes, dual-quaternion blending)           -> warp.field, core.dualquat
* k-NN node lookup (replaces nanoflann KD-tree)                      -> ops.knn
* Gauss-Newton non-rigid solver (replaces the Opt/Terra DSL)         -> solver.gn
* rigid + non-rigid engines                                          -> engine.kinfu, engine.dynfusion
* multi-chip sharding (block-partitioned TSDF, psum-reduced GN)      -> dist.spmd
* dataset IO / exports / CLI                                         -> io

Parity target: the reference's test suites (test/quaternion_test.cpp,
test/opt_optimisation_test.cpp) at their tolerances, and its demo pipeline
behavior (src/dynfu/dyn_fusion.cpp), re-expressed as pure-JAX programs.
"""

__version__ = "0.1.0"

from dynfu_tpu.engine.params import KinFuParams, DynFuParams, Intr  # noqa: F401


def __getattr__(name):
    # lazy engine imports keep `import dynfu_tpu` light
    if name == "DynFusion":
        from dynfu_tpu.engine.dynfusion import DynFusion

        return DynFusion
    if name == "KinFu":
        from dynfu_tpu.engine.kinfu import KinFu

        return KinFu
    raise AttributeError(name)
