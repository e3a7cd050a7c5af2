from .sampler import DistributedSampler  # noqa: F401
from .mnist import MNIST, SyntheticMNIST, load_mnist  # noqa: F401
from .loader import DataLoader  # noqa: F401
from .dataset import ConcatDataset, Subset, TensorDataset, random_split  # noqa: F401
from .worker_pool import WorkerInfo, get_worker_info  # noqa: F401
