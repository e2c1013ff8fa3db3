"""The port's losses, with the names scflow_tpu.losses exports, imported
at first use."""

from scflow_tpu_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "raft_loss": "basic", "l1_loss": "basic", "sequence_loss": "basic",
    "endpoint_error": "basic", "point_matching_loss": "point_matching",
    "disentangle_point_matching_loss": "point_matching",
    "rot_point_matching_loss": "point_matching", "sym_mask_from_types": "point_matching",
})
