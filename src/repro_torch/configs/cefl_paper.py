"""The paper's own FL workload: a small image classifier (F-MNIST scale)
trained with CE-FL over the UE/BS/DC network (Sec. VI / App. G).
Counterpart of ``repro.configs.cefl_paper`` (the classifier config only)."""
import dataclasses


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
