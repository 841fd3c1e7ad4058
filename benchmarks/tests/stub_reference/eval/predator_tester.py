from reference.aprref.eval import predator_tester
from stub_reference import TESTER_CALLS, recording

RecordingTester = recording(predator_tester.PredatorTester, "reference",
                            TESTER_CALLS)
