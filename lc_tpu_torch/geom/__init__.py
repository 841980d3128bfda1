from .rotations import (quaternion_to_matrix, matrix_to_quaternion,
                        axis_angle_to_matrix, axis_angle_to_quaternion,
                        quaternion_raw_multiply, skew_symmetric)
from .pose import pose7_to_RT, RT_to_pose7, apply_perturb
from .projection import project_apply, gen_uv
