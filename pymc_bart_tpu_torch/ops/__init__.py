from .draw import (fused_draw_supported, fused_draw_unsupported_reason,
                   pgbart_step_fused, pgbart_step_fused_plain)
from .grow import grow_round, grow_round_plain
from .predict import (forest_predict, forest_predict_excluded, leaf_values_at,
                      tree_leaf_index, tree_predict, tree_predict_excluded)
from .select import select_refine, select_refine_plain
from .smc import smc_resample, smc_resample_plain
from .trees import (Forest, decide_left, depth_of_slot, init_forest,
                    level_slots, subset_member)

__all__ = [
    "Forest", "decide_left", "depth_of_slot", "forest_predict",
    "forest_predict_excluded", "fused_draw_supported",
    "fused_draw_unsupported_reason", "grow_round", "grow_round_plain",
    "init_forest", "leaf_values_at", "level_slots", "pgbart_step_fused",
    "pgbart_step_fused_plain", "select_refine", "select_refine_plain", "smc_resample",
    "smc_resample_plain", "subset_member", "tree_leaf_index", "tree_predict",
    "tree_predict_excluded",
]
