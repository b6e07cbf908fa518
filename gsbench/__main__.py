import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from gsbench.host import few_threads

    few_threads()  # before numpy and torch are imported

    from gsbench.run import main

    sys.exit(main(t_start=T_START))
