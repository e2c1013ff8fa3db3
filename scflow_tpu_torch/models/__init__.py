"""The port's network modules, with the names scflow_tpu.models exports,
imported at first use."""

from scflow_tpu_torch import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "ConvModule": "layers", "InstanceNorm": "layers", "RAFTEncoder": "raft_encoder",
    "MotionEncoder": "motion", "ConvGRU": "motion", "XHead": "motion",
    "SingleClassPoseHead": "pose_head", "MultiClassPoseHead": "pose_head",
    "RAFTDecoder": "raft_decoder", "RAFTDecoderMask": "raft_decoder",
    "SCFlowDecoder": "scflow_decoder", "ResNet": "resnet", "ResNetV1d": "resnet",
    "DenseLayer": "densenet", "BasicDenseBlock": "densenet",
})
