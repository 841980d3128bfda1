from .error6d import add_err, adi_err, re_err, te_err, batched_pose_errors
from .evaluator import (Evaluator, gen_score_table, compute_auc_posecnn,
                        csv_from_results)
from .ply import load_ply_vertices
