from .progress import get_num_threads, setup_logging, track_progress_and_resources

__all__ = ["track_progress_and_resources", "setup_logging", "get_num_threads"]
