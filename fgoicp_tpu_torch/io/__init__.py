from .loader import load_cloud, load_cloud_txt, subsample_cloud
from .ply import read_ply_vertices, write_ply
