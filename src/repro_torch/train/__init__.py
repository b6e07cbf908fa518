"""Training: loss, optimizers, plan staging and the trainer
(``repro_torch.train.trainer``)."""
