"""Talos-class humanoid model (free-flyer + 6-dof legs + torso + 4-dof arms).

Hand-authored analog of the reduced Talos the reference's walking workload
uses (``examples/talos_walk.py`` loads Talos "no wrist/head":
nq=29, nv=28, nu=22). Masses/lengths are in the published Talos class
(~92 kg total, 0.38 m thighs, 0.325 m shins); the exact inertial values are
nominal — the point of this model is a humanoid-*scale* workload (nv=28,
multi-contact), not binary parity with the URDF.

Joint order (matching the reference's reduced Talos layout):
  free-flyer pelvis,
  left leg  (hip yaw z, hip roll x, hip pitch y, knee y, ankle pitch y, ankle roll x),
  right leg (same),
  torso     (yaw z, pitch y),
  left arm  (shoulder pitch y, shoulder roll x, shoulder yaw z, elbow y),
  right arm (same).
Operational frames: left_sole / right_sole (flat feet), left_gripper /
right_gripper.
"""

from __future__ import annotations

import jax.numpy as jnp

from .model import FREEFLYER, REVOLUTE, make_model, frame_placement

# plain tuples (NOT jnp arrays): module import must not initialize a jax
# backend (JAX_PLATFORMS=cpu selects the CPU; the default is the GPU).
X = (1.0, 0.0, 0.0)
Y = (0.0, 1.0, 0.0)
Z = (0.0, 0.0, 1.0)


def _box_inertia(m, lx, ly, lz):
    return jnp.diag(
        jnp.array(
            [
                m / 12.0 * (ly**2 + lz**2),
                m / 12.0 * (lx**2 + lz**2),
                m / 12.0 * (lx**2 + ly**2),
            ]
        )
    )


def make_humanoid(
    pelvis_mass=15.0,
    hip_y_off=0.085,
    thigh_len=0.38,
    shin_len=0.325,
    ankle_height=0.107,
    torso_height=0.2,
    shoulder_y_off=0.1575,
    shoulder_height=0.157,
    upper_arm_len=0.27,
    forearm_len=0.25,
):
    """Build the nv=28 humanoid. Total mass ≈ 92 kg."""
    joints = [
        dict(
            type=FREEFLYER,
            parent=-1,
            mass=pelvis_mass,
            com=jnp.array([0.0, 0.0, 0.05]),
            inertia=_box_inertia(pelvis_mass, 0.25, 0.3, 0.2),
        )
    ]
    frames = []

    def add(parent, axis, placement, mass, com, inertia):
        joints.append(
            dict(
                type=REVOLUTE,
                parent=parent,
                axis=axis,
                placement_p=placement,
                mass=mass,
                com=com,
                inertia=inertia,
            )
        )
        return len(joints) - 1

    # --- legs ---
    for side, sy in (("left", +1.0), ("right", -1.0)):
        hip_yaw = add(
            0, Z, jnp.array([0.0, sy * hip_y_off, -0.075]),
            1.8, jnp.zeros(3), _box_inertia(1.8, 0.1, 0.1, 0.1),
        )
        hip_roll = add(
            hip_yaw, X, jnp.zeros(3),
            2.2, jnp.zeros(3), _box_inertia(2.2, 0.1, 0.1, 0.1),
        )
        hip_pitch = add(  # thigh
            hip_roll, Y, jnp.zeros(3),
            6.2, jnp.array([0.0, 0.0, -thigh_len / 2]),
            _box_inertia(6.2, 0.12, 0.12, thigh_len),
        )
        knee = add(  # shin
            hip_pitch, Y, jnp.array([0.0, 0.0, -thigh_len]),
            3.6, jnp.array([0.0, 0.0, -shin_len / 2]),
            _box_inertia(3.6, 0.1, 0.1, shin_len),
        )
        ankle_pitch = add(
            knee, Y, jnp.array([0.0, 0.0, -shin_len]),
            1.3, jnp.zeros(3), _box_inertia(1.3, 0.08, 0.08, 0.08),
        )
        ankle_roll = add(  # foot
            ankle_pitch, X, jnp.zeros(3),
            1.5, jnp.array([0.02, 0.0, -ankle_height / 2]),
            _box_inertia(1.5, 0.21, 0.13, ankle_height),
        )
        frames.append(
            dict(
                name=f"{side}_sole",
                parent=ankle_roll,
                placement_p=jnp.array([0.0, 0.0, -ankle_height]),
            )
        )

    # --- torso ---
    torso_yaw = add(
        0, Z, jnp.array([0.0, 0.0, torso_height]),
        3.0, jnp.zeros(3), _box_inertia(3.0, 0.15, 0.2, 0.1),
    )
    torso_pitch = add(  # chest
        torso_yaw, Y, jnp.zeros(3),
        17.0, jnp.array([0.0, 0.0, 0.15]),
        _box_inertia(17.0, 0.25, 0.3, 0.35),
    )

    # --- arms ---
    for side, sy in (("left", +1.0), ("right", -1.0)):
        sh_pitch = add(
            torso_pitch, Y,
            jnp.array([0.0, sy * shoulder_y_off, shoulder_height]),
            2.0, jnp.zeros(3), _box_inertia(2.0, 0.1, 0.1, 0.1),
        )
        sh_roll = add(
            sh_pitch, X, jnp.zeros(3),
            2.2, jnp.array([0.0, 0.0, -upper_arm_len / 2]),
            _box_inertia(2.2, 0.08, 0.08, upper_arm_len),
        )
        sh_yaw = add(
            sh_roll, Z, jnp.array([0.0, 0.0, -upper_arm_len]),
            1.5, jnp.zeros(3), _box_inertia(1.5, 0.07, 0.07, 0.07),
        )
        elbow = add(  # forearm + hand
            sh_yaw, Y, jnp.zeros(3),
            2.3, jnp.array([0.0, 0.0, -forearm_len / 2]),
            _box_inertia(2.3, 0.06, 0.06, forearm_len),
        )
        frames.append(
            dict(
                name=f"{side}_gripper",
                parent=elbow,
                placement_p=jnp.array([0.0, 0.0, -forearm_len]),
            )
        )

    return make_model(joints, frames)


def make_humanoid_upper_body(
    torso_height=0.2,
    shoulder_y_off=0.1575,
    shoulder_height=0.157,
    upper_arm_len=0.27,
    forearm_len=0.25,
):
    """Fixed-base upper body: torso (yaw, pitch) + two 4-dof arms (nv=10,
    fully actuated). Counterpart of the reference's Talos upper-body model
    (``examples/talos_arms.py`` loads it via ``load_talos_upper_body``,
    ``examples/utils/__init__.py``); same arm geometry as
    :func:`make_humanoid`, with the pelvis welded to the world."""
    joints = [
        dict(
            type=REVOLUTE,
            parent=-1,
            axis=Z,
            placement_p=jnp.array([0.0, 0.0, torso_height]),
            mass=3.0,
            com=jnp.zeros(3),
            inertia=_box_inertia(3.0, 0.15, 0.2, 0.1),
        )
    ]
    frames = []

    def add(parent, axis, placement, mass, com, inertia):
        joints.append(
            dict(
                type=REVOLUTE,
                parent=parent,
                axis=axis,
                placement_p=placement,
                mass=mass,
                com=com,
                inertia=inertia,
            )
        )
        return len(joints) - 1

    torso_pitch = add(  # chest
        0, Y, jnp.zeros(3),
        17.0, jnp.array([0.0, 0.0, 0.15]),
        _box_inertia(17.0, 0.25, 0.3, 0.35),
    )
    for side, sy in (("left", +1.0), ("right", -1.0)):
        sh_pitch = add(
            torso_pitch, Y,
            jnp.array([0.0, sy * shoulder_y_off, shoulder_height]),
            2.0, jnp.zeros(3), _box_inertia(2.0, 0.1, 0.1, 0.1),
        )
        sh_roll = add(
            sh_pitch, X, jnp.zeros(3),
            2.2, jnp.array([0.0, 0.0, -upper_arm_len / 2]),
            _box_inertia(2.2, 0.08, 0.08, upper_arm_len),
        )
        sh_yaw = add(
            sh_roll, Z, jnp.array([0.0, 0.0, -upper_arm_len]),
            1.5, jnp.zeros(3), _box_inertia(1.5, 0.07, 0.07, 0.07),
        )
        elbow = add(  # forearm + hand
            sh_yaw, Y, jnp.zeros(3),
            2.3, jnp.array([0.0, 0.0, -forearm_len / 2]),
            _box_inertia(2.3, 0.06, 0.06, forearm_len),
        )
        frames.append(
            dict(
                name=f"{side}_gripper",
                parent=elbow,
                placement_p=jnp.array([0.0, 0.0, -forearm_len]),
            )
        )
    return make_model(joints, frames)


def upper_body_effort_limits():
    """Torque limits for :func:`make_humanoid_upper_body` (torso + 2×arm)."""
    torso = jnp.array([78.0, 78.0])
    arm = jnp.array([44.0, 44.0, 30.0, 30.0])
    return jnp.concatenate([torso, arm, arm])


# indices of the leg pitch dofs in v-space (after the 6 base dofs):
# per leg: [yaw, roll, pitch, knee, ankle_pitch, ankle_roll]
_LEG0 = 6  # left leg first dof in v / (q offset is +1 for the quaternion)


def half_sitting(model, hip_pitch=-0.411, knee=0.859, ankle_pitch=-0.448):
    """Talos-like half-sitting configuration with both soles flat at z=0.

    The base height is computed from this model's own FK so the soles land
    exactly on the ground plane regardless of parameter overrides.
    """
    q = model.neutral()
    for leg in range(2):
        base = 7 + 6 * leg  # q offset: 7 base coords, then 6 per leg
        q = q.at[base + 2].set(hip_pitch)
        q = q.at[base + 3].set(knee)
        q = q.at[base + 4].set(ankle_pitch)
    # arms: slight elbow bend
    arm0 = 7 + 12 + 2
    for arm in range(2):
        q = q.at[arm0 + 4 * arm + 1].set(0.2 * (1 if arm == 0 else -1))
        q = q.at[arm0 + 4 * arm + 3].set(-0.5)
    _, p_sole = frame_placement(model, q, model.frame_id("left_sole"))
    q = q.at[2].set(-p_sole[2])
    return q


def actuation_matrix(model):
    """(nv, nu) selector: all joints actuated except the free-flyer."""
    nv = model.nv
    nu = nv - 6
    return jnp.eye(nv, nu, -6)


def effort_limits():
    """Per-actuator torque limits (Talos-class magnitudes), order = v[6:]."""
    leg = jnp.array([100.0, 160.0, 160.0, 300.0, 160.0, 100.0])
    torso = jnp.array([78.0, 78.0])
    arm = jnp.array([44.0, 44.0, 30.0, 30.0])
    return jnp.concatenate([leg, leg, torso, arm, arm])
