"""The port's train-to-accuracy loop (``repro_torch.train.stdp_trainer``)."""
from repro_torch.train.stdp_trainer import (SamplerSource, TrainerConfig, assign_labels,
                                            assignment_accuracy, assignment_predict,
                                            evaluate, train_to_accuracy)
