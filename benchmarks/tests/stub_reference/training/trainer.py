from reference.aprref.training import trainer
from stub_reference import USED


class FCGFTrainer(trainer.FCGFTrainer):
    def __init__(self, *args, **kw):
        USED.append("side")
        super().__init__(*args, **kw)
