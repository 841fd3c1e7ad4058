from reference.aprref.training import predator
from stub_reference import TRAINER_CALLS, recording

RecordingTrainer = recording(predator.PredatorTrainer, "reference",
                             TRAINER_CALLS)
