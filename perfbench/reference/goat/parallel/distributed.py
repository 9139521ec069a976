"""One process: the collectives the frozen files name do nothing."""


def all_reduce_sum(x):
    return x


def gather_rows(x):
    return x


def all_reduce_grads(params) -> None:
    return None


def reduce_metrics(metrics, *args, **kwargs):
    return metrics


def process_index() -> int:
    return 0
