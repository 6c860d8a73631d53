"""The paper's own four DNNs (§5.1): TDS (speech), CNN10, ResNet18 and
Darknet19, field for field as ``repro.configs.paper_dnns``.  ReLU
activations throughout, batch-norm where the paper's building blocks
(Fig. 2) use it; the CNNs take 32 x 32 images, 10 classes."""
from repro_torch.configs.base import ModelConfig, MoRConfig, register


@register("paper-tds")
def paper_tds() -> ModelConfig:
    # Time-Depth-Separable ASR blocks (Hannun et al. 2019): CONV+ReLU then
    # FC+ReLU then FC, residual + layernorm.
    return ModelConfig(
        name="paper-tds",
        family="tds",
        n_layers=4,
        d_model=144,
        d_ff=288,
        vocab_size=128,
        activation="relu",
        norm="layernorm",
        dtype="float32",
        param_dtype="float32",
        mor=MoRConfig(enabled=True, relufied=False, corr_threshold=0.8),
    )


@register("paper-cnn10")
def paper_cnn10() -> ModelConfig:
    # ten conv layers, BN+ReLU (paper Fig. 2b)
    return ModelConfig(
        name="paper-cnn10",
        family="cnn",
        n_layers=10,
        d_model=0,
        cnn_channels=(3, 32, 32, 64, 64, 128, 128, 128, 256, 256, 256),
        cnn_num_classes=10,
        img_size=32,
        batchnorm=True,
        residual=False,
        activation="relu",
        dtype="float32",
        param_dtype="float32",
        mor=MoRConfig(enabled=True, relufied=False),
    )


@register("paper-resnet18")
def paper_resnet18() -> ModelConfig:
    # ResNet18 building block: conv-BN-ReLU with residual (paper Fig. 2c)
    return ModelConfig(
        name="paper-resnet18",
        family="cnn",
        n_layers=18,
        d_model=0,
        cnn_channels=(3, 64, 64, 64, 64, 128, 128, 128, 128,
                      256, 256, 256, 256, 512, 512, 512, 512),
        cnn_num_classes=10,
        img_size=32,
        batchnorm=True,
        residual=True,
        activation="relu",
        dtype="float32",
        param_dtype="float32",
        mor=MoRConfig(enabled=True, relufied=False),
    )


@register("paper-darknet19")
def paper_darknet19() -> ModelConfig:
    # Darknet19 (Redmon & Farhadi): conv-BN-ReLU stacks, no residual
    return ModelConfig(
        name="paper-darknet19",
        family="cnn",
        n_layers=19,
        d_model=0,
        cnn_channels=(3, 32, 64, 128, 64, 128, 256, 128, 256,
                      512, 256, 512, 256, 512, 1024, 512, 1024, 512, 1024),
        cnn_num_classes=10,
        img_size=32,
        batchnorm=True,
        residual=False,
        activation="relu",
        dtype="float32",
        param_dtype="float32",
        mor=MoRConfig(enabled=True, relufied=False),
    )
