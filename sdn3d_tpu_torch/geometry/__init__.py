"""geometry (PyTorch port of sdn3d_tpu.geometry)."""

from sdn3d_tpu_torch.geometry.ffd import FFD, Constraint, make_ffd_basis
from sdn3d_tpu_torch.geometry.transforms import (
    perspective_transform,
    quaternion_to_matrix,
    y_rotation_quaternion,
)
from sdn3d_tpu_torch.geometry.camera import look, look_at, perspective_divide
from sdn3d_tpu_torch.geometry.obj import load_obj, save_obj
