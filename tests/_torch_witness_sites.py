"""Lock acquisition sites for ``tests/test_torch_locks.py``. The witness
drops frames of files whose name ends in ``locks.py`` (its own module,
in both packages) from the sites it reports, and the test's file name
ends so too; acquiring here keeps a site of this repo's code in every
message."""
import threading


def run(fn):
    """Run ``fn`` on a thread named ``witness-helper``, re-raising
    anything it raised."""
    box = []

    def wrapper():
        try:
            fn()
        except BaseException as e:   # pragma: no cover - re-raised
            box.append(e)

    t = threading.Thread(target=wrapper, name="witness-helper")
    t.start()
    t.join()
    if box:
        raise box[0]


def nest(outer, inner):
    with outer:
        with inner:
            pass
