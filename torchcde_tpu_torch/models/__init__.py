from .neural_cde import NeuralCDE, NeuralCDEConfig, bce_with_logits
from .training import accuracy, make_loss_fn, make_train_step

__all__ = ["NeuralCDE", "NeuralCDEConfig", "accuracy", "bce_with_logits", "make_loss_fn",
           "make_train_step"]
