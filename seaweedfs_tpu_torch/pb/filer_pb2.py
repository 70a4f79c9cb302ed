# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66iler.proto\x12\x08\x66iler_pb\"=\n\x06\x46ileId\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08\x66ile_key\x18\x02 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x03 \x01(\x07\"\xec\x01\n\tFileChunk\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x16\n\x0emodified_ts_ns\x18\x04 \x01(\x03\x12\r\n\x05\x65_tag\x18\x05 \x01(\t\x12\x1d\n\x03\x66id\x18\x07 \x01(\x0b\x32\x10.filer_pb.FileId\x12$\n\nsource_fid\x18\x08 \x01(\x0b\x32\x10.filer_pb.FileId\x12\x12\n\ncipher_key\x18\t \x01(\x0c\x12\x15\n\ris_compressed\x18\n \x01(\x08\x12\x19\n\x11is_chunk_manifest\x18\x0b \x01(\x08\"8\n\x11\x46ileChunkManifest\x12#\n\x06\x63hunks\x18\x01 \x03(\x0b\x32\x13.filer_pb.FileChunk\"\x8a\x02\n\x0e\x46useAttributes\x12\x11\n\tfile_size\x18\x01 \x01(\x04\x12\r\n\x05mtime\x18\x02 \x01(\x03\x12\x11\n\tfile_mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0e\n\x06\x63rtime\x18\x06 \x01(\x03\x12\x0c\n\x04mime\x18\x07 \x01(\t\x12\x0f\n\x07ttl_sec\x18\n \x01(\x05\x12\x11\n\tuser_name\x18\x0b \x01(\t\x12\x12\n\ngroup_name\x18\x0c \x03(\t\x12\x16\n\x0esymlink_target\x18\r \x01(\t\x12\x0b\n\x03md5\x18\x0e \x01(\x0c\x12\x11\n\tdisk_type\x18\x0f \x01(\t\x12\x0c\n\x04rdev\x18\x10 \x01(\r\x12\r\n\x05inode\x18\x11 \x01(\x04\"\xd1\x02\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12#\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x13.filer_pb.FileChunk\x12,\n\nattributes\x18\x04 \x01(\x0b\x32\x18.filer_pb.FuseAttributes\x12/\n\x08\x65xtended\x18\x05 \x03(\x0b\x32\x1d.filer_pb.Entry.ExtendedEntry\x12\x14\n\x0chard_link_id\x18\x07 \x01(\x0c\x12\x19\n\x11hard_link_counter\x18\x08 \x01(\x05\x12\x0f\n\x07\x63ontent\x18\t \x01(\x0c\x12\x1e\n\x16worm_enforced_at_ts_ns\x18\n \x01(\x03\x12\r\n\x05quota\x18\x0b \x01(\x03\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"8\n\tFullEntry\x12\x0b\n\x03\x64ir\x18\x01 \x01(\t\x12\x1e\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\">\n\x1bLookupDirectoryEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\">\n\x1cLookupDirectoryEntryResponse\x12\x1e\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\"\x82\x01\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x1c\n\x14start_from_file_name\x18\x03 \x01(\t\x12\x1c\n\x14inclusive_start_from\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\"5\n\x13ListEntriesResponse\x12\x1e\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\"\xaf\x01\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1e\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x0e\n\x06o_excl\x18\x03 \x01(\x08\x12\x1d\n\x15is_from_other_cluster\x18\x04 \x01(\x08\x12\x12\n\nsignatures\x18\x05 \x03(\x05\x12#\n\x1bskip_check_parent_directory\x18\x06 \x01(\x08\"$\n\x13\x43reateEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"z\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1e\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x1d\n\x15is_from_other_cluster\x18\x03 \x01(\x08\x12\x12\n\nsignatures\x18\x04 \x03(\x05\"\x15\n\x13UpdateEntryResponse\"b\n\x14\x41ppendToEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x12\n\nentry_name\x18\x02 \x01(\t\x12#\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x13.filer_pb.FileChunk\"\x17\n\x15\x41ppendToEntryResponse\"\xb6\x01\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x16\n\x0eis_delete_data\x18\x04 \x01(\x08\x12\x14\n\x0cis_recursive\x18\x05 \x01(\x08\x12\x1e\n\x16ignore_recursive_error\x18\x06 \x01(\x08\x12\x1d\n\x15is_from_other_cluster\x18\x07 \x01(\x08\x12\x12\n\nsignatures\x18\x08 \x03(\x05\"$\n\x13\x44\x65leteEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\x80\x01\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\x12\x12\n\nsignatures\x18\x05 \x03(\x05\"\x1b\n\x19\x41tomicRenameEntryResponse\"\x80\x01\n\x18StreamRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\x12\x12\n\nsignatures\x18\x05 \x03(\x05\"v\n\x19StreamRenameEntryResponse\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x37\n\x12\x65vent_notification\x18\x02 \x01(\x0b\x32\x1b.filer_pb.EventNotification\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"I\n&CacheRemoteObjectToLocalClusterRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"I\n\'CacheRemoteObjectToLocalClusterResponse\x12\x1e\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\"\xb5\x01\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x04 \x01(\x05\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04path\x18\x06 \x01(\t\x12\x0c\n\x04rack\x18\x07 \x01(\t\x12\x11\n\tdata_node\x18\t \x01(\t\x12\x11\n\tdisk_type\x18\x08 \x01(\t\"\xa2\x01\n\x14\x41ssignVolumeResponse\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x05\x12\x0c\n\x04\x61uth\x18\x05 \x01(\t\x12\x12\n\ncollection\x18\x06 \x01(\t\x12\x13\n\x0breplication\x18\x07 \x01(\t\x12\r\n\x05\x65rror\x18\x08 \x01(\t\x12$\n\x08location\x18\t \x01(\x0b\x32\x12.filer_pb.Location\"S\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x13\n\x0b\x64\x61ta_center\x18\x04 \x01(\t\"2\n\tLocations\x12%\n\tlocations\x18\x01 \x03(\x0b\x32\x12.filer_pb.Location\")\n\x13LookupVolumeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\t\"\xa9\x01\n\x14LookupVolumeResponse\x12G\n\rlocations_map\x18\x01 \x03(\x0b\x32\x30.filer_pb.LookupVolumeResponse.LocationsMapEntry\x1aH\n\x11LocationsMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.filer_pb.Locations:\x02\x38\x01\"\x1a\n\nCollection\x12\x0c\n\x04name\x18\x01 \x01(\t\"S\n\x15\x43ollectionListRequest\x12\x1e\n\x16include_normal_volumes\x18\x01 \x01(\x08\x12\x1a\n\x12include_ec_volumes\x18\x02 \x01(\x08\"C\n\x16\x43ollectionListResponse\x12)\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x14.filer_pb.Collection\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"\x1a\n\x18\x44\x65leteCollectionResponse\"\\\n\x11StatisticsRequest\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\x12\x11\n\tdisk_type\x18\x04 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x04 \x01(\x04\x12\x11\n\tused_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\"\x1e\n\x1cGetFilerConfigurationRequest\"\xfd\x01\n\x1dGetFilerConfigurationResponse\x12\x0f\n\x07masters\x18\x01 \x03(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0e\n\x06max_mb\x18\x04 \x01(\r\x12\x13\n\x0b\x64ir_buckets\x18\x05 \x01(\t\x12\x0e\n\x06\x63ipher\x18\x07 \x01(\x08\x12\x11\n\tsignature\x18\x08 \x01(\x05\x12\x17\n\x0fmetrics_address\x18\t \x01(\t\x12\x1c\n\x14metrics_interval_sec\x18\n \x01(\x05\x12\x0f\n\x07version\x18\x0b \x01(\t\x12\x12\n\ncluster_id\x18\x0c \x01(\t\"\xbe\x01\n\x11\x45ventNotification\x12\"\n\told_entry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\"\n\tnew_entry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x15\n\rdelete_chunks\x18\x03 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x04 \x01(\t\x12\x1d\n\x15is_from_other_cluster\x18\x05 \x01(\x08\x12\x12\n\nsignatures\x18\x06 \x03(\x05\"\xa5\x01\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x10\n\x08since_ns\x18\x03 \x01(\x03\x12\x11\n\tsignature\x18\x04 \x01(\x05\x12\x15\n\rpath_prefixes\x18\x06 \x03(\t\x12\x11\n\tclient_id\x18\x07 \x01(\x05\x12\x10\n\x08until_ns\x18\x08 \x01(\x03\"v\n\x19SubscribeMetadataResponse\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x37\n\x12\x65vent_notification\x18\x02 \x01(\x0b\x32\x1b.filer_pb.EventNotification\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"\x1b\n\x0cKvGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\"-\n\rKvGetResponse\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"*\n\x0cKvPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"\x1e\n\rKvPutResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"2\n\x0bPingRequest\x12\x0e\n\x06target\x18\x01 \x01(\t\x12\x13\n\x0btarget_type\x18\x02 \x01(\t\"S\n\x0cPingResponse\x12\x15\n\rstart_time_ns\x18\x01 \x01(\x03\x12\x16\n\x0eremote_time_ns\x18\x02 \x01(\x03\x12\x14\n\x0cstop_time_ns\x18\x03 \x01(\x03\x32\xd9\r\n\x0cSeaweedFiler\x12g\n\x14LookupDirectoryEntry\x12%.filer_pb.LookupDirectoryEntryRequest\x1a&.filer_pb.LookupDirectoryEntryResponse\"\x00\x12N\n\x0bListEntries\x12\x1c.filer_pb.ListEntriesRequest\x1a\x1d.filer_pb.ListEntriesResponse\"\x00\x30\x01\x12L\n\x0b\x43reateEntry\x12\x1c.filer_pb.CreateEntryRequest\x1a\x1d.filer_pb.CreateEntryResponse\"\x00\x12L\n\x0bUpdateEntry\x12\x1c.filer_pb.UpdateEntryRequest\x1a\x1d.filer_pb.UpdateEntryResponse\"\x00\x12R\n\rAppendToEntry\x12\x1e.filer_pb.AppendToEntryRequest\x1a\x1f.filer_pb.AppendToEntryResponse\"\x00\x12L\n\x0b\x44\x65leteEntry\x12\x1c.filer_pb.DeleteEntryRequest\x1a\x1d.filer_pb.DeleteEntryResponse\"\x00\x12^\n\x11\x41tomicRenameEntry\x12\".filer_pb.AtomicRenameEntryRequest\x1a#.filer_pb.AtomicRenameEntryResponse\"\x00\x12`\n\x11StreamRenameEntry\x12\".filer_pb.StreamRenameEntryRequest\x1a#.filer_pb.StreamRenameEntryResponse\"\x00\x30\x01\x12O\n\x0c\x41ssignVolume\x12\x1d.filer_pb.AssignVolumeRequest\x1a\x1e.filer_pb.AssignVolumeResponse\"\x00\x12O\n\x0cLookupVolume\x12\x1d.filer_pb.LookupVolumeRequest\x1a\x1e.filer_pb.LookupVolumeResponse\"\x00\x12U\n\x0e\x43ollectionList\x12\x1f.filer_pb.CollectionListRequest\x1a .filer_pb.CollectionListResponse\"\x00\x12[\n\x10\x44\x65leteCollection\x12!.filer_pb.DeleteCollectionRequest\x1a\".filer_pb.DeleteCollectionResponse\"\x00\x12I\n\nStatistics\x12\x1b.filer_pb.StatisticsRequest\x1a\x1c.filer_pb.StatisticsResponse\"\x00\x12j\n\x15GetFilerConfiguration\x12&.filer_pb.GetFilerConfigurationRequest\x1a\'.filer_pb.GetFilerConfigurationResponse\"\x00\x12`\n\x11SubscribeMetadata\x12\".filer_pb.SubscribeMetadataRequest\x1a#.filer_pb.SubscribeMetadataResponse\"\x00\x30\x01\x12\x65\n\x16SubscribeLocalMetadata\x12\".filer_pb.SubscribeMetadataRequest\x1a#.filer_pb.SubscribeMetadataResponse\"\x00\x30\x01\x12:\n\x05KvGet\x12\x16.filer_pb.KvGetRequest\x1a\x17.filer_pb.KvGetResponse\"\x00\x12:\n\x05KvPut\x12\x16.filer_pb.KvPutRequest\x1a\x17.filer_pb.KvPutResponse\"\x00\x12\x88\x01\n\x1f\x43\x61\x63heRemoteObjectToLocalCluster\x12\x30.filer_pb.CacheRemoteObjectToLocalClusterRequest\x1a\x31.filer_pb.CacheRemoteObjectToLocalClusterResponse\"\x00\x12\x37\n\x04Ping\x12\x15.filer_pb.PingRequest\x1a\x16.filer_pb.PingResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._options = None
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_options = b'8\001'
  _FILEID._serialized_start=25
  _FILEID._serialized_end=86
  _FILECHUNK._serialized_start=89
  _FILECHUNK._serialized_end=325
  _FILECHUNKMANIFEST._serialized_start=327
  _FILECHUNKMANIFEST._serialized_end=383
  _FUSEATTRIBUTES._serialized_start=386
  _FUSEATTRIBUTES._serialized_end=652
  _ENTRY._serialized_start=655
  _ENTRY._serialized_end=992
  _ENTRY_EXTENDEDENTRY._serialized_start=945
  _ENTRY_EXTENDEDENTRY._serialized_end=992
  _FULLENTRY._serialized_start=994
  _FULLENTRY._serialized_end=1050
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_start=1052
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_end=1114
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_start=1116
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_end=1178
  _LISTENTRIESREQUEST._serialized_start=1181
  _LISTENTRIESREQUEST._serialized_end=1311
  _LISTENTRIESRESPONSE._serialized_start=1313
  _LISTENTRIESRESPONSE._serialized_end=1366
  _CREATEENTRYREQUEST._serialized_start=1369
  _CREATEENTRYREQUEST._serialized_end=1544
  _CREATEENTRYRESPONSE._serialized_start=1546
  _CREATEENTRYRESPONSE._serialized_end=1582
  _UPDATEENTRYREQUEST._serialized_start=1584
  _UPDATEENTRYREQUEST._serialized_end=1706
  _UPDATEENTRYRESPONSE._serialized_start=1708
  _UPDATEENTRYRESPONSE._serialized_end=1729
  _APPENDTOENTRYREQUEST._serialized_start=1731
  _APPENDTOENTRYREQUEST._serialized_end=1829
  _APPENDTOENTRYRESPONSE._serialized_start=1831
  _APPENDTOENTRYRESPONSE._serialized_end=1854
  _DELETEENTRYREQUEST._serialized_start=1857
  _DELETEENTRYREQUEST._serialized_end=2039
  _DELETEENTRYRESPONSE._serialized_start=2041
  _DELETEENTRYRESPONSE._serialized_end=2077
  _ATOMICRENAMEENTRYREQUEST._serialized_start=2080
  _ATOMICRENAMEENTRYREQUEST._serialized_end=2208
  _ATOMICRENAMEENTRYRESPONSE._serialized_start=2210
  _ATOMICRENAMEENTRYRESPONSE._serialized_end=2237
  _STREAMRENAMEENTRYREQUEST._serialized_start=2240
  _STREAMRENAMEENTRYREQUEST._serialized_end=2368
  _STREAMRENAMEENTRYRESPONSE._serialized_start=2370
  _STREAMRENAMEENTRYRESPONSE._serialized_end=2488
  _CACHEREMOTEOBJECTTOLOCALCLUSTERREQUEST._serialized_start=2490
  _CACHEREMOTEOBJECTTOLOCALCLUSTERREQUEST._serialized_end=2563
  _CACHEREMOTEOBJECTTOLOCALCLUSTERRESPONSE._serialized_start=2565
  _CACHEREMOTEOBJECTTOLOCALCLUSTERRESPONSE._serialized_end=2638
  _ASSIGNVOLUMEREQUEST._serialized_start=2641
  _ASSIGNVOLUMEREQUEST._serialized_end=2822
  _ASSIGNVOLUMERESPONSE._serialized_start=2825
  _ASSIGNVOLUMERESPONSE._serialized_end=2987
  _LOCATION._serialized_start=2989
  _LOCATION._serialized_end=3072
  _LOCATIONS._serialized_start=3074
  _LOCATIONS._serialized_end=3124
  _LOOKUPVOLUMEREQUEST._serialized_start=3126
  _LOOKUPVOLUMEREQUEST._serialized_end=3167
  _LOOKUPVOLUMERESPONSE._serialized_start=3170
  _LOOKUPVOLUMERESPONSE._serialized_end=3339
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_start=3267
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_end=3339
  _COLLECTION._serialized_start=3341
  _COLLECTION._serialized_end=3367
  _COLLECTIONLISTREQUEST._serialized_start=3369
  _COLLECTIONLISTREQUEST._serialized_end=3452
  _COLLECTIONLISTRESPONSE._serialized_start=3454
  _COLLECTIONLISTRESPONSE._serialized_end=3521
  _DELETECOLLECTIONREQUEST._serialized_start=3523
  _DELETECOLLECTIONREQUEST._serialized_end=3568
  _DELETECOLLECTIONRESPONSE._serialized_start=3570
  _DELETECOLLECTIONRESPONSE._serialized_end=3596
  _STATISTICSREQUEST._serialized_start=3598
  _STATISTICSREQUEST._serialized_end=3690
  _STATISTICSRESPONSE._serialized_start=3692
  _STATISTICSRESPONSE._serialized_end=3771
  _GETFILERCONFIGURATIONREQUEST._serialized_start=3773
  _GETFILERCONFIGURATIONREQUEST._serialized_end=3803
  _GETFILERCONFIGURATIONRESPONSE._serialized_start=3806
  _GETFILERCONFIGURATIONRESPONSE._serialized_end=4059
  _EVENTNOTIFICATION._serialized_start=4062
  _EVENTNOTIFICATION._serialized_end=4252
  _SUBSCRIBEMETADATAREQUEST._serialized_start=4255
  _SUBSCRIBEMETADATAREQUEST._serialized_end=4420
  _SUBSCRIBEMETADATARESPONSE._serialized_start=4422
  _SUBSCRIBEMETADATARESPONSE._serialized_end=4540
  _KVGETREQUEST._serialized_start=4542
  _KVGETREQUEST._serialized_end=4569
  _KVGETRESPONSE._serialized_start=4571
  _KVGETRESPONSE._serialized_end=4616
  _KVPUTREQUEST._serialized_start=4618
  _KVPUTREQUEST._serialized_end=4660
  _KVPUTRESPONSE._serialized_start=4662
  _KVPUTRESPONSE._serialized_end=4692
  _PINGREQUEST._serialized_start=4694
  _PINGREQUEST._serialized_end=4744
  _PINGRESPONSE._serialized_start=4746
  _PINGRESPONSE._serialized_end=4829
  _SEAWEEDFILER._serialized_start=4832
  _SEAWEEDFILER._serialized_end=6585
# @@protoc_insertion_point(module_scope)
