"""Geometry & math substrate: Lie groups, planes, cameras, closed-form solvers.

JAX replacement for the reference's Sophus (SE3/Sim3), g2o plane3d, and
`CameraModels/` (reference: orb_slam3/Thirdparty/Sophus, g2o/types/plane3d.h,
orb_slam3/include/CameraModels).  Everything here is pure JAX, dtype
polymorphic, free of data-dependent control flow, and safe under vmap/jit.
"""

from visual_sgraphs.core import lie, plane, cameras, geometry  # noqa: F401
