"""The port's training: the LM step with AdamW / ITP-AdamW
(``repro_torch.train.train_step``, ``repro_torch.train.optimizer``) and the
SNNs' train-to-accuracy loop (``repro_torch.train.stdp_trainer``)."""
from repro_torch.train.optimizer import (OptimizerConfig, OptState, adamw_update,
                                         init_opt_state, lr_schedule)
from repro_torch.train.stdp_trainer import (SamplerSource, TrainerConfig, assign_labels,
                                            assignment_accuracy, assignment_predict,
                                            evaluate, train_to_accuracy)
from repro_torch.train.train_step import (TrainConfig, init_training, lm_loss, loss_and_grads,
                                         make_train_step)
