"""Small thread-pool helpers: the port's copy of
``horovod_tpu/run/threads.py`` (reference horovod/run/util/threads.py)."""

import concurrent.futures


def execute_function_multithreaded(fn, arg_tuples, max_workers=None):
    """Run fn(*args) for each args in arg_tuples concurrently; returns the
    list of results in completion order. Exceptions propagate."""
    if not arg_tuples:
        return []
    max_workers = max_workers or min(32, len(arg_tuples))
    with concurrent.futures.ThreadPoolExecutor(max_workers) as pool:
        futures = [pool.submit(fn, *args) for args in arg_tuples]
        return [f.result() for f in
                concurrent.futures.as_completed(futures)]


def on_event(event, fn, args=(), daemon=True):
    """Invoke fn(*args) on a background thread once event is set
    (reference threads.py in_thread/on_event)."""
    import threading

    def waiter():
        event.wait()
        fn(*args)

    t = threading.Thread(target=waiter, daemon=daemon)
    t.start()
    return t
