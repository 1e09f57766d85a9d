"""A stand-in for ``repro_torch.capture.Capture`` on a machine without a
card, shared by the tests of the port's compiled steps
(``test_torch_train_capture.py``, ``test_torch_prefill_capture.py``)."""


class _CPUCapture:
    """``capture.Capture`` without a device: ``warm_up`` runs the step,
    ``capture`` records the function and runs nothing (as a recording
    launches nothing), ``replay`` runs it on the recorded inputs and puts
    its outputs where the recording's were.  The first recording of a
    pool makes it (``pool``), as the card's graph does."""
    made = []

    def __init__(self, device, pool=None):
        self.launches, self.seconds, self.replays = {}, {}, 0
        self.out = {}
        self.pool = pool
        _CPUCapture.made.append(self)

    def warm_up(self, fn, *args):
        return fn(*args)

    def capture(self, fn, *args):
        self.fn, self.args = fn, args
        if self.pool is None:
            self.pool = object()
        return self.out

    def replay(self):
        self.replays += 1
        out = self.fn(*self.args)
        self.out.clear()
        self.out.update(out)
