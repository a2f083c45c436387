"""The paper's own model: GroupNorm ResNet (BatchNorm→GN per App. A), used by
the Table II / III / IV experiments on synthetic CIFAR-like data (copied as
data from ``repro.configs.paper_cnn``). CONFIG takes ResNet18's stage
widths (64, 128, 256, 512), two blocks a stage, GN with 32 groups and the
cut after the first stage; REDUCED is the CI-speed version used by tests."""
from repro_torch.models.cnn import CNNConfig

CONFIG = CNNConfig(name="paper-gn-resnet", num_classes=10, image_size=32,
                   channels=(64, 128, 256, 512), blocks_per_stage=2,
                   group_size=32, cut_stage=1)

REDUCED = CNNConfig(name="paper-gn-resnet-reduced", num_classes=10,
                    image_size=16, channels=(16, 32), blocks_per_stage=1,
                    group_size=8, cut_stage=1)
