"""The paper's own FL workload: a small image classifier (F-MNIST scale)
trained with CE-FL over the UE/BS/DC network (Sec. VI / App. G).
Counterpart of ``repro.configs.cefl_paper``."""
import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    name: str = "cefl-paper-cnn"
    input_shape: tuple = (28, 28, 1)   # F-MNIST; CIFAR variant: (32, 32, 3)
    num_classes: int = 10
    hidden: tuple = (200, 100)
    dtype: str = "float32"


CLASSIFIER = ClassifierConfig()
CLASSIFIER_CIFAR = ClassifierConfig(name="cefl-paper-cnn-cifar",
                                    input_shape=(32, 32, 3))

# ModelConfig view (used only by the registry; FL experiments use CLASSIFIER)
CONFIG = ModelConfig(
    name="cefl-paper",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    head_dim=64,
    source="paper Sec. VI / App. G (F-MNIST workload)",
)
