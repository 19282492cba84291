from .cli import main
from .parallel.mesh import shutdown_distributed

if __name__ == "__main__":
    main()
    shutdown_distributed()
