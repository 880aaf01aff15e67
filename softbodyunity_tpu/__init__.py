"""softbodyunity_tpu — a soft-body simulation engine in JAX.

A brand-new rebuild of SoftbodyUnity as a
JAX/XLA/Pallas framework: mass-spring + XPBD cloth and volumetric soft
bodies, plane/sphere/self collision, batched and sharded across devices.
See SURVEY.md for the component map and BASELINE.json for the capability
contract.
"""

from .api import (
    apply_impulse,
    ensure_plastic_state,
    ensure_shapematch_state,
    ensure_tear_state,
    init,
    move_colliders,
    move_pins,
    move_tethers,
    normals,
    pick_vertex,
    raycast,
    rollout,
    step,
    step_coupled,
    suggest_dt,
)
from .solver.rigid import RigidState, make_rigid_state
from .core.config import (
    CollisionParams,
    MotionConstraintParams,
    PlasticityParams,
    PressureParams,
    SelfCollisionParams,
    ShapeMatchParams,
    StrainLimitParams,
    SimConfig,
    Solver,
    SpringParams,
    TearParams,
    WindParams,
    XPBDParams,
)
from .core.embed import MeshEmbedding, embed_mesh, skin, skin_normals
from .core.state import State, make_state
from .core.topology import (
    HostTopology,
    Topology,
    add_colliders,
    add_rigid_joint,
    anchor,
    attach,
    attach_box,
    cloth_grid,
    enable_pressure,
    enable_shape_matching,
    from_tet_mesh,
    from_triangle_mesh,
    icosphere_mesh,
    lattice_from_mesh,
    merge_bodies,
    rope,
    set_motion_constraints,
    stitch,
    terrain_mesh,
    tet_cube,
)
from .models import presets
from .utils.profiling import (
    contact_impulses,
    contact_impulses_batched,
    diagnostics,
)
from .utils.render import render_frame, render_rollout

__version__ = "0.1.0"
__all__ = [
    "init", "step", "rollout", "normals", "move_colliders", "move_pins",
    "move_tethers", "set_motion_constraints", "MotionConstraintParams",
    "add_colliders", "raycast", "pick_vertex",
    "diagnostics", "contact_impulses", "contact_impulses_batched",
    "apply_impulse", "suggest_dt",
    "ensure_tear_state", "ensure_plastic_state", "ensure_shapematch_state",
    "SimConfig", "Solver", "SpringParams", "XPBDParams", "WindParams",
    "TearParams", "PlasticityParams", "PressureParams", "ShapeMatchParams",
    "StrainLimitParams",
    "CollisionParams", "SelfCollisionParams",
    "State", "make_state", "Topology", "HostTopology",
    "cloth_grid", "tet_cube", "rope", "from_triangle_mesh", "from_tet_mesh",
    "merge_bodies", "stitch", "presets",
    "enable_pressure", "enable_shape_matching",
    "icosphere_mesh", "anchor", "attach", "attach_box",
    "add_rigid_joint",
    "terrain_mesh",
    "lattice_from_mesh",
    "render_frame", "render_rollout",
    "MeshEmbedding", "embed_mesh", "skin", "skin_normals",
    "step_coupled", "RigidState", "make_rigid_state",
]
